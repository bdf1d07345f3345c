"""Window node features and constant edge rows.

Port of the window part of ``ginfinity_tpu/graphs/build.py``.
Standard node features are ``[w*paired, w*unpaired, loop_size_norm,
loop_pos_norm]`` (+ a ``seq_weight``-scaled ACGU one-hot when
``seq_weight > 0``), ``w = 1 - seq_weight``.  Forgi models place the
same block in their 16-wide layout ``[4 struct, 4 seq, is_base, 7 type]``.
"""

from __future__ import annotations

import numpy as np

from ginfinity_tpu_torch.graphs.dotbracket import loop_features, one_hot_sequence

FORGI_NODE_TYPES = (
    "five_prime",
    "stem",
    "hairpin",
    "internal",
    "multiloop",
    "three_prime",
    "other",
)


def standard_node_features(
    pt: np.ndarray,
    sequence: str | None,
    seq_weight: float,
    feature_dim: int | None = None,
) -> np.ndarray:
    """Standard node feature block; ``feature_dim`` truncates or
    zero-pads it for checkpoints of another input width."""
    n = pt.shape[0]
    paired = (pt >= 0).astype(np.float32)
    loop_size_norm, loop_pos_norm = loop_features(pt)
    w = 1.0 - seq_weight
    cols = [w * paired, w * (1.0 - paired), loop_size_norm, loop_pos_norm]
    feat = np.stack(cols, axis=1).astype(np.float32)
    if seq_weight > 0:
        feat = np.concatenate([feat, seq_weight * one_hot_sequence(sequence, n)], axis=1)
    if feature_dim is not None and feature_dim != feat.shape[1]:
        if feature_dim < feat.shape[1]:
            feat = feat[:, :feature_dim]
        else:
            feat = np.pad(feat, ((0, 0), (0, feature_dim - feat.shape[1])))
    return feat


def window_node_features(
    pt: np.ndarray,
    sequence: str | None,
    seq_weight: float,
    graph_encoding: str = "standard",
    feature_dim: int | None = None,
) -> np.ndarray:
    """Node features of base-only window graphs in a model's feature
    space: the standard block, or for forgi models the same block in
    the forgi layout with ``is_base=1`` and no element type."""
    if (graph_encoding or "standard").lower() != "forgi":
        return standard_node_features(pt, sequence, seq_weight, feature_dim)
    n = pt.shape[0]
    fdim = (
        feature_dim
        if feature_dim is not None
        else 4 + 4 + 1 + len(FORGI_NODE_TYPES)
    )
    std = standard_node_features(pt, sequence, seq_weight)
    feat = np.zeros((n, fdim), np.float32)
    c = min(std.shape[1], 8, fdim)
    feat[:, :c] = std[:, :c]
    if fdim > 8:
        feat[:, 8] = 1.0  # is_base
    return feat


def window_edge_const_rows(edge_dim: int) -> np.ndarray:
    """Constant edge-attr rows ``[adj_from_next, adj_from_prev, bp_fwd,
    bp_bwd]`` for the standard (4) or forgi (7) edge layout: adjacent /
    base_pair flags in cols 0/1, is_forward / is_backward in the last two
    cols; forgi's middle cols (meta-edge classes) stay zero."""
    rows = np.zeros((4, edge_dim), np.float32)
    rows[0, 0] = rows[1, 0] = 1.0  # adjacent
    rows[2, 1] = rows[3, 1] = 1.0  # base_pair
    fwd, bwd = edge_dim - 2, edge_dim - 1
    rows[0, bwd] = 1.0  # message from the next node: src > dst
    rows[1, fwd] = 1.0
    rows[2, fwd] = 1.0
    rows[3, bwd] = 1.0
    return rows
