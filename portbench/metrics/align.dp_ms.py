"""``align.dp_ms``: each call of ``ops/dp.py::affine_align_batch`` (root
span ``dp.align_batch``: packing into pinned memory, the upload, K2, the
wait for it, the walk kernel, the download and the decode into step
lists), mean host milliseconds a batch."""

from portbench import spans


def read(r):
    ms = spans.root_ms("dp.align_batch")
    return sum(ms) / len(ms) if ms else None
