"""``align.traceback_ms``: the host's Python walk of each pair's path
(``ops/dp.py::_traceback_global`` or ``_traceback_local``, span
``dp.traceback``), milliseconds per ``affine_align_batch`` call (span
``dp.align_batch``)."""

from portbench import spans


def read(r):
    return spans.per_root("dp.align_batch", ("dp.traceback",))
