"""Bytes and operations of K2, the affine-gap DP wavefront
(``ginfinity_tpu_torch/ops/csrc/dp_wavefront.cu``), per pair of real
lengths ``l1 x l2``: every real score read once (float32), and one
traceback code byte written for each cell of the pair's
``(l1 + 1) x (l2 + 1)`` rectangle; about ten float32 operations a cell
(three maxima, four adds, the comparisons that make the codes)."""

from __future__ import annotations

OPS_PER_CELL = 10


def nbytes(l1: int, l2: int) -> float:
    return 4.0 * l1 * l2 + (l1 + 1) * (l2 + 1)


def ops(l1: int, l2: int) -> float:
    return float(OPS_PER_CELL * (l1 + 1) * (l2 + 1))
