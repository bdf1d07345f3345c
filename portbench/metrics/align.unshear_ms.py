"""``align.unshear_ms``: the host's un-shear of each pair's diagonal
codes into dense planes of the batch's padded size
(``ops/dp.py::_codes_dense``, span ``dp.unshear``), milliseconds per
``affine_align_batch`` call (span ``dp.align_batch``)."""

from portbench import spans


def read(r):
    return spans.per_root("dp.align_batch", ("dp.unshear",))
