"""What the per-layer metrics read of the program's own spans and counts
(``ginfinity_tpu_torch/utils/trace.py``).  The program records them only
while a profiler runs, and ``run.py`` forgets them just before its traced
segment, so in a ``--trace 1`` run they are those of the traced segment.
A checkout whose program lacks the module, or a segment without the
spans a metric needs, reads ``None``."""


def _trace():
    try:
        from ginfinity_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def recorded():
    """The program's finished spans, or ``None`` without the module."""
    trace = _trace()
    return None if trace is None else trace.recorded()


def clear() -> None:
    """Forget the program's finished spans (nothing without the module)."""
    trace = _trace()
    if trace is not None:
        trace.clear()


def roots(recs, root: str) -> list:
    return [r for r in recs or () if r.name == root and r.parent is None]


def root_ms(root: str, device: bool = False):
    """Milliseconds of each root span ``root`` (host stamps, or with
    ``device`` their CUDA events); ``None`` when there is none."""
    ms = [r.device_ms if device else r.ms for r in roots(recorded(), root)]
    return ms if ms and None not in ms else None


def per_root(root: str, names: tuple, device: bool = False):
    """Milliseconds of the spans ``names`` under the root spans ``root``
    (host stamps, or with ``device`` their CUDA events), summed and
    divided by the number of roots; ``None`` when either is absent."""
    recs = recorded()
    tops = roots(recs, root)
    requests = {r.request for r in tops}
    kids = [r for r in recs or () if r.name in names and r.request in requests]
    ms = [r.device_ms if device else r.ms for r in kids]
    if not tops or not kids or None in ms:
        return None
    return sum(ms) / len(tops)
