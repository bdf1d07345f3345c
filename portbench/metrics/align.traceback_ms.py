"""``align.traceback_ms``: the walk of each pair's path and its way to
the host (span ``dp.traceback``: ``ops/dp_traceback.py::dp_traceback``,
the walk kernel on the card's codes, the download of the scores and
paths into pinned memory, the decode into step lists), milliseconds per
``affine_align_batch`` call (span ``dp.align_batch``)."""

from portbench import spans


def read(r):
    return spans.per_root("dp.align_batch", ("dp.traceback",))
