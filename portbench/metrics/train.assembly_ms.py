"""``train.assembly_ms``: the host clock around each call of
``training/data.py::assemble_alignment_batch`` (graphs packed, labels,
the mined subset), mean milliseconds a batch."""


def read(r):
    s = r.spans.get("train.assembly")
    return 1e3 * sum(s) / len(s) if s else None
