"""Spans and counts inside the port, on the profiler's clock.

    from ginfinity_tpu_torch.utils import trace

    with trace.span("dp.align_batch") as sp:
        ...
        sp.add(pairs=64)

Tracing is on while a ``torch.profiler`` is active, or inside ``with
trace.recording():``; there is no other switch.  Off, :func:`span`
returns one shared no-op object: it reads no clock, allocates nothing
and never synchronises.  On, a span stamps ``time.time_ns()`` at enter
and at exit (the clock of the profiler's kineto events), records its
parent (the innermost open span of its thread) and a request id (a fresh
one for each root span, inherited by every span under it), and, while a
profiler is active, opens ``torch.profiler.record_function(name)`` inside
its stamps, so that it sits on the profiler's timeline beside the
kernels.  A span with ``device`` set to a CUDA device (or ``True``: the
current one) also records a pair of CUDA events on that device's current
stream, resolved only when read; their time includes any wait of the
stream for the host to enqueue the span's work.

Finished spans accumulate until :func:`clear`; :func:`recorded` returns
them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch

_clock = time.time_ns
_local = threading.local()  # .stack: the open spans of this thread
_finished: list = []
_pending: list = []         # finished spans whose CUDA events are unread
_ids = itertools.count(1)
_recording = 0


def enabled() -> bool:
    """Whether spans record: a profiler is active, or ``recording()`` is
    open."""
    return _recording > 0 or torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with no profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


@dataclasses.dataclass
class Record:
    """A finished span: wall-clock stamps in ns, its id, its parent's id
    (``None`` at a root), its request id, its counts and, for a device
    span, the CUDA events' milliseconds."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    request: int
    counts: dict
    device_ms: float | None = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_device(device):
    """The CUDA device that ``device`` names, or ``None``."""
    if device is True:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() and torch.cuda.is_initialized() else None
    if isinstance(device, torch.device) and device.type == "cuda":
        return device
    return None


class _Span:
    __slots__ = ("record", "_rf", "_events", "_device", "_stream")

    def __init__(self, name: str, device):
        self.record = Record(name, 0, 0, next(_ids), None, 0, {})
        self._device = _cuda_device(device) if device else None
        self._rf = self._events = None

    def __enter__(self):
        rec, stack = self.record, _stack()
        if stack:
            rec.parent, rec.request = stack[-1].record.id, stack[-1].record.request
        else:
            rec.request = rec.id
        stack.append(self)
        rec.start_ns = _clock()
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(rec.name)
            self._rf.__enter__()
        if self._device is not None:
            self._stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.record.end_ns = _clock()
        _stack().pop()
        _finished.append(self.record)
        if self._events is not None:
            _pending.append((self.record, self._events, self._device))
        return False

    def add(self, **counts) -> None:
        """Add ``counts`` to the span's counts (summed by name)."""
        c = self.record.counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v


def span(name: str, device=False):
    """A span named ``name`` (a context manager with ``add(**counts)``);
    ``device``: a CUDA device (or ``True``, the current one) whose
    stream gets a pair of timing events around the span."""
    if not enabled():
        return _OFF
    return _Span(name, device)


def current():
    """The innermost open span of this thread (the no-op span when none
    is open or tracing is off)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack and enabled() else _OFF


def recorded() -> list[Record]:
    """The spans finished since :func:`clear`, in the order they ended;
    pending CUDA events are resolved first (one synchronisation per
    device that has any)."""
    if _pending:
        for d in {d for *_, d in _pending}:
            torch.cuda.synchronize(d)
        for rec, (a, b), _ in _pending:
            rec.device_ms = a.elapsed_time(b)
        _pending.clear()
    return list(_finished)


def clear() -> None:
    """Forget every finished span."""
    _finished.clear()
    _pending.clear()


def self_ns(rec: Record, records: list[Record]) -> int:
    """``rec``'s duration less the part of it its children cover."""
    kids = sum(r.end_ns - r.start_ns for r in records if r.parent == rec.id)
    return rec.end_ns - rec.start_ns - kids
