"""Operations and bytes of K1, the window encoder
(``ginfinity_tpu_torch/ops/csrc/windows_encoder.cu``), counted from the
real rows of each window: its ``L`` positions and the outside partners
it pulls in.  K1 computes every GINE layer, the node norm, the pooling
and the fc head of a chunk of windows; the node encoder runs before it.
"""

from __future__ import annotations

import numpy as np

from portbench.counts import gine


def window_rows(pt: np.ndarray, L: int) -> np.ndarray:
    """Real rows of every window start ``0 .. n - L``: ``L`` plus the
    partners outside the window of its paired positions (pairs between
    backbone neighbours excepted)."""
    n = pt.shape[0]
    ns = n - L + 1
    if ns <= 0:
        return np.zeros(0, np.int64)
    i = np.arange(n)
    up = (pt > i) & (pt - i != 1)
    a, b = i[up], pt[up]
    diff = np.zeros(ns + 1, np.int64)

    def add(lo, hi):  # +1 on starts lo .. hi
        lo, hi = np.maximum(lo, 0), np.minimum(hi, ns - 1)
        ok = lo <= hi
        np.add.at(diff, lo[ok], 1)
        np.add.at(diff, hi[ok] + 1, -1)

    add(a - L + 1, np.minimum(a, b - L))        # a inside, b beyond the window
    add(np.maximum(a + 1, b - L + 1), b)         # b inside, a before the window
    return L + np.cumsum(diff[:ns])


def param_bytes(cfg: dict) -> int:
    """float32 bytes of the weights K1 reads: each layer's MLP, edge rows
    and norm, and the fc head."""
    total = 0
    for a, b in gine.layer_widths(cfg):
        total += a * b + b * b + 2 * b + 4 * a + 3 * b
    total += cfg["hidden_dims"][-1] * cfg["output_dim"] + cfg["output_dim"]
    return 4 * total


def flops(cfg: dict, rows: float, windows: float) -> float:
    return gine.mlp_flops(cfg, rows) + gine.head_flops(cfg, windows)


def nbytes(cfg: dict, rows: float, windows: float, L: int, launches: int) -> float:
    """Inputs read once and the output written once: the encoded rows,
    five flags a position, the weights once a launch, one output row a
    window."""
    h0 = cfg["hidden_dims"][0]
    return 4.0 * (rows * h0 + windows * (5 * L + cfg["output_dim"])) \
        + launches * param_bytes(cfg)
