"""Operations of the host similarity of one pair
(``pipelines/align.py::cosine_similarity_matrix``): the product of its
two sets of normalised rows, ``l1 x d`` by ``d x l2``, 2·l1·l2·d FLOPs.
The rows' norms (about 3·(l1 + l2)·d) are left out: under 3% of the
product at d 128 and lengths of 100 or more."""

from __future__ import annotations


def flops(l1: int, l2: int, d: int) -> float:
    return 2.0 * l1 * l2 * d
