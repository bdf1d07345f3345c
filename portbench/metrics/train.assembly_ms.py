"""``train.assembly_ms``: each call of
``training/data.py::assemble_alignment_batch`` (root span
``train.assembly``: graphs packed, labels, the mined subset), mean host
milliseconds a batch."""

from portbench import spans


def read(r):
    ms = spans.root_ms("train.assembly")
    return sum(ms) / len(ms) if ms else None
