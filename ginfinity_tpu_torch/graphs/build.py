"""Graph construction: dot-bracket -> flat arrays, and the window rows.

Port of ``ginfinity_tpu/graphs/build.py``: the standard encoding's
:class:`GraphArrays` (node features, both-ways directed edges with
``[adjacent, base_pair, is_forward, is_backward]`` attributes), the
window node features and the constant window edge rows, and the forgi
encoding (:func:`build_forgi`): the bases plus one meta-node per
structural element (``graphs/forgi_elements.py``).

Standard node features are ``[w*paired, w*unpaired, loop_size_norm,
loop_pos_norm]`` (+ a ``seq_weight``-scaled ACGU one-hot when
``seq_weight > 0``), ``w = 1 - seq_weight``.  Forgi nodes are 16 wide,
``[4 struct, 4 seq, is_base, 7-way element type]``, and forgi edges 7
wide, ``[adj, bp, meta->base, base->meta, meta<->meta, fwd, bwd]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ginfinity_tpu_torch.graphs.dotbracket import loop_features, one_hot_sequence, pair_table
from ginfinity_tpu_torch.graphs.forgi_elements import decompose_elements, element_connections

FORGI_NODE_TYPES = (
    "five_prime",
    "stem",
    "hairpin",
    "internal",
    "multiloop",
    "three_prime",
    "other",
)
FORGI_TYPE_TO_INDEX = {name: idx for idx, name in enumerate(FORGI_NODE_TYPES)}
FORGI_EDGE_DIM = 7


@dataclasses.dataclass
class GraphArrays:
    """One RNA structure as flat host arrays.  ``edge_src/edge_dst`` list
    every directed edge, ``edge_attr`` is per directed edge;
    ``n_base_nodes`` counts the real bases (all nodes in the standard
    encoding)."""

    node_feat: np.ndarray  # [N, F] float32
    edge_src: np.ndarray  # [E] int32
    edge_dst: np.ndarray  # [E] int32
    edge_attr: np.ndarray  # [E, Fe] float32
    n_nodes: int
    n_base_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


def _directed_both_ways(src: np.ndarray, dst: np.ndarray,
                        attr_base: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every undirected edge in both directions, with ``[is_forward,
    is_backward]`` appended to its attributes."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    a = np.concatenate([attr_base, attr_base], axis=0)
    fwd = (s < d).astype(np.float32)[:, None]
    return s, d, np.concatenate([a, fwd, 1.0 - fwd], axis=1)


def _fit_width(feat: np.ndarray, feature_dim: int | None) -> np.ndarray:
    """Truncate or zero-pad node features to ``feature_dim`` columns."""
    if feature_dim is None or feature_dim == feat.shape[1]:
        return feat
    if feature_dim < feat.shape[1]:
        return feat[:, :feature_dim]
    return np.pad(feat, ((0, 0), (0, feature_dim - feat.shape[1])))


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
    return _fit_width(feat, feature_dim)


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


def _standard_edges(pt: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Backbone edges ``(i, i-1)`` and one edge per base pair ``(i, pt[i])``,
    ``i < pt[i]``, both ways.  A pair whose partner is its backbone
    neighbour (``pt[i] == i + 1``) gives no base-pair edge: the
    reference's simple graph overwrites it with the adjacent edge."""
    n = pt.shape[0]
    bb_src = np.arange(1, n, dtype=np.int32)
    bb_dst = bb_src - 1
    i = np.arange(n, dtype=np.int32)
    bp_mask = (pt >= 0) & (i < pt) & (pt != i + 1)
    bp_src = i[bp_mask]
    bp_dst = pt[bp_mask].astype(np.int32)

    src = np.concatenate([bb_src, bp_src])
    dst = np.concatenate([bb_dst, bp_dst])
    attr = np.zeros((src.shape[0], 2), dtype=np.float32)
    attr[: bb_src.shape[0], 0] = 1.0  # adjacent
    attr[bb_src.shape[0]:, 1] = 1.0  # base_pair
    return _directed_both_ways(src, dst, attr)


def build_standard(
    structure: str,
    sequence: str | None = None,
    seq_weight: float = 0.0,
    feature_dim: int | None = None,
) -> GraphArrays:
    pt = pair_table(structure)
    feat = standard_node_features(pt, sequence, seq_weight, feature_dim)
    src, dst, attr = _standard_edges(pt)
    return GraphArrays(
        node_feat=feat,
        edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32),
        edge_attr=attr,
        n_nodes=pt.shape[0],
        n_base_nodes=pt.shape[0],
    )


def _meta_edges(src: list, dst: list, col: list) -> np.ndarray:
    """7-wide attributes of meta edges: a one-hot class column, then
    ``[is_forward, is_backward]``."""
    attr = np.zeros((len(src), FORGI_EDGE_DIM), np.float32)
    attr[np.arange(len(src)), col] = 1.0
    fwd = (np.asarray(src) < np.asarray(dst)).astype(np.float32)
    attr[:, 5] = fwd
    attr[:, 6] = 1.0 - fwd
    return attr


def build_forgi(
    structure: str,
    sequence: str | None = None,
    seq_weight: float = 0.0,
    feature_dim: int | None = None,
) -> GraphArrays:
    """Forgi encoding: the ``n`` bases first, then one meta-node per
    structural element.  Edges, in order: the standard base-level edges
    widened to 7 columns; for each element and each member base, meta ->
    base (column 2) then base -> meta (column 3); for each connected
    element pair ``(a, b)``, a -> b then b -> a (column 4)."""
    pt = pair_table(structure)
    n = pt.shape[0]
    elements = decompose_elements(pt)

    paired = (pt >= 0).astype(np.float32)
    loop_size_norm, loop_pos_norm = loop_features(pt)
    w = 1.0 - seq_weight
    total = n + len(elements)
    feat = np.zeros((total, 4 + 4 + 1 + len(FORGI_NODE_TYPES)), np.float32)
    feat[:n, 0:4] = np.stack([w * paired, w * (1.0 - paired), loop_size_norm, loop_pos_norm],
                             axis=1)
    if seq_weight > 0:
        feat[:n, 4:8] = seq_weight * one_hot_sequence(sequence, n)
    feat[:n, 8] = 1.0  # is_base
    for k, el in enumerate(elements):
        feat[n + k, 9 + FORGI_TYPE_TO_INDEX.get(el.kind, FORGI_TYPE_TO_INDEX["other"])] = 1.0

    src_b, dst_b, attr_b4 = _standard_edges(pt)
    attr_b = np.zeros((src_b.shape[0], FORGI_EDGE_DIM), np.float32)
    attr_b[:, 0:2] = attr_b4[:, 0:2]
    attr_b[:, 5:7] = attr_b4[:, 2:4]

    src, dst, col = [], [], []
    for k, el in enumerate(elements):
        for member in el.members:
            src += [n + k, member]
            dst += [member, n + k]
            col += [2, 3]
    for a, b in element_connections(elements):
        src += [n + a, n + b]
        dst += [n + b, n + a]
        col += [4, 4]
    return GraphArrays(
        node_feat=_fit_width(feat, feature_dim),
        edge_src=np.concatenate([src_b, np.asarray(src, np.int32)]).astype(np.int32),
        edge_dst=np.concatenate([dst_b, np.asarray(dst, np.int32)]).astype(np.int32),
        edge_attr=np.concatenate([attr_b, _meta_edges(src, dst, col)]),
        n_nodes=total,
        n_base_nodes=n,
    )


def build_graph_arrays(
    structure: str,
    sequence: str | None = None,
    seq_weight: float = 0.0,
    graph_encoding: str = "standard",
    feature_dim: int | None = None,
) -> GraphArrays:
    encoding = (graph_encoding or "standard").lower()
    if encoding == "standard":
        return build_standard(structure, sequence, seq_weight, feature_dim)
    if encoding == "forgi":
        return build_forgi(structure, sequence, seq_weight, feature_dim)
    raise ValueError(f"Unsupported graph_encoding '{graph_encoding}'")
