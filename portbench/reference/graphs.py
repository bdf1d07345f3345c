"""Plain graph construction from dot-bracket strings (numpy only).

A frozen copy of the reference featurizer's math, written out
independently of the program: the standard encoding (node features
``[paired, unpaired, loop_size_norm, loop_pos_norm]``, backbone and
base-pair edges with ``[adjacent, base_pair, is_forward, is_backward]``
attributes), the sliding-window subgraph with pulled paired neighbours,
and the forgi encoding (bases plus one meta-node per structural
element).  Only nested ``(``/``)``/``.`` structures are accepted: the
benchmark's generators make no other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FORGI_KINDS = ("five_prime", "stem", "hairpin", "internal", "multiloop", "three_prime", "other")


@dataclasses.dataclass
class Graph:
    feat: np.ndarray  # [N, F] float32
    src: np.ndarray  # [E] int64
    dst: np.ndarray  # [E] int64
    attr: np.ndarray  # [E, Fe] float32
    n_bases: int

    @property
    def n_nodes(self) -> int:
        return self.feat.shape[0]


def pair_table(structure: str) -> np.ndarray:
    """``pt[i]`` = partner of ``i`` or -1."""
    pt = np.full(len(structure), -1, np.int64)
    stack = []
    for i, c in enumerate(structure):
        if c == "(":
            stack.append(i)
        elif c == ")":
            if not stack:
                raise ValueError("unbalanced structure")
            j = stack.pop()
            pt[i], pt[j] = j, i
        elif c != ".":
            raise ValueError(f"unsupported character {c!r}")
    if stack:
        raise ValueError("unbalanced structure")
    return pt


def loop_features(pt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per unpaired position: its run's length over the sequence length,
    and its place in the run over (run length - 1), 0.5 in a run of one;
    0 at paired positions."""
    n = pt.shape[0]
    size = np.zeros(n, np.float32)
    pos = np.zeros(n, np.float32)
    i = 0
    while i < n:
        if pt[i] >= 0:
            i += 1
            continue
        j = i
        while j < n and pt[j] < 0:
            j += 1
        run = j - i
        for k in range(i, j):
            size[k] = np.float32(run / n)
            pos[k] = np.float32((k - i) / (run - 1)) if run > 1 else np.float32(0.5)
        i = j
    return size, pos


def node_features(pt: np.ndarray, width: int) -> np.ndarray:
    """The standard block, cut or zero-padded to ``width`` columns."""
    paired = (pt >= 0).astype(np.float32)
    size, pos = loop_features(pt)
    feat = np.stack([paired, 1.0 - paired, size, pos], axis=1).astype(np.float32)
    if width <= 4:
        return np.ascontiguousarray(feat[:, :width])
    return np.pad(feat, ((0, 0), (0, width - 4)))


def _both_ways(src, dst, attr2):
    s = np.concatenate([src, dst]).astype(np.int64)
    d = np.concatenate([dst, src]).astype(np.int64)
    a = np.concatenate([attr2, attr2])
    fwd = (s < d).astype(np.float32)[:, None]
    return s, d, np.concatenate([a, fwd, 1.0 - fwd], axis=1).astype(np.float32)


def _base_edges(pt: np.ndarray):
    """Backbone edges ``(i, i-1)`` and one edge per base pair ``(i, j)``,
    ``i < j``, not between backbone neighbours (such a pair is the
    backbone edge), both ways."""
    n = pt.shape[0]
    i = np.arange(n)
    bb = np.arange(1, n)
    bp = i[(pt > i) & (pt != i + 1)]
    attr = np.zeros((bb.size + bp.size, 2), np.float32)
    attr[: bb.size, 0] = 1.0
    attr[bb.size:, 1] = 1.0
    return _both_ways(np.concatenate([bb, bp]), np.concatenate([bb - 1, pt[bp]]), attr)


def standard_graph(structure: str, width: int) -> Graph:
    pt = pair_table(structure)
    s, d, a = _base_edges(pt)
    return Graph(node_features(pt, width), s, d, a, pt.shape[0])


def window_features(pt: np.ndarray, width: int, encoding: str) -> np.ndarray:
    """Node features of a structure's window graphs in a model's feature
    space: the standard block cut or padded to ``width``; for a forgi
    model the same four columns in the forgi layout (``forgi_graph``'s
    bases: ``is_base`` set, no element type)."""
    feat = node_features(pt, width)
    if encoding == "forgi":
        feat[:, 8] = 1.0
    return feat


def window_graph(pt: np.ndarray, feat: np.ndarray, start: int, L: int,
                 edge_dim: int = 4) -> Graph:
    """The window ``[start, start + L)`` of a structure with its outside
    partners pulled in: nodes are the kept positions in position order;
    backbone edges inside the window; base-pair edges (not between
    backbone neighbours) whose two ends are kept.  Edge rows are
    ``[adj, bp, fwd, bwd]``, or for ``edge_dim`` 7 the forgi layout
    ``[adj, bp, 0, 0, 0, fwd, bwd]``."""
    n = pt.shape[0]
    win = np.arange(start, start + L)
    part = pt[win]
    real = (part >= 0) & (np.abs(part - win) != 1)
    outside = part[real & ((part < start) | (part >= start + L))]
    nodes = np.sort(np.concatenate([win, outside]))
    local = np.full(n, -1, np.int64)
    local[nodes] = np.arange(nodes.size)
    bb = np.arange(start + 1, start + L)
    cand = nodes[(pt[nodes] > nodes) & (pt[nodes] != nodes + 1)]
    bp = cand[local[pt[cand]] >= 0]
    attr = np.zeros((bb.size + bp.size, 2), np.float32)
    attr[: bb.size, 0] = 1.0
    attr[bb.size:, 1] = 1.0
    s, d, a = _both_ways(np.concatenate([local[bb], local[bp]]),
                         np.concatenate([local[bb - 1], local[pt[bp]]]), attr)
    if edge_dim != 4:
        wide = np.zeros((a.shape[0], edge_dim), np.float32)
        wide[:, :2], wide[:, -2:] = a[:, :2], a[:, 2:]
        a = wide
    return Graph(feat[nodes], s, d, a, nodes.size)


# -- forgi encoding -----------------------------------------------------------


def _stems(pt: np.ndarray) -> tuple[list[tuple[int, int, int]], dict[int, int]]:
    """Maximal runs of stacked pairs ``(i0 + d, j0 - d)``, ``d <= k``."""
    n = pt.shape[0]
    stems, where = [], {}
    i = 0
    while i < n:
        j = int(pt[i])
        if j > i and i not in where:
            k = 0
            while i + k + 1 < n and int(pt[i + k + 1]) == j - k - 1 and j - k - 1 > i + k + 1:
                k += 1
            for d in range(k + 1):
                where[i + d] = where[j - d] = len(stems)
            stems.append((i, j, k))
            i += k + 1
        else:
            i += 1
    return stems, where


def _level(pt, lo: int, hi: int, where) -> tuple[list[list[int]], list[int]]:
    """Unpaired runs and the stems between them at one nesting level."""
    runs, stems = [[]], []
    i = lo
    while i <= hi:
        j = int(pt[i])
        if j > i:
            stems.append(where[i])
            runs.append([])
            i = j + 1
        else:
            runs[-1].append(i)
            i += 1
    return runs, stems


def forgi_elements(pt: np.ndarray) -> list[tuple[str, list[int], list[int]]]:
    """``(kind, member positions, stems it borders)`` of every element:
    stems first, then the exterior loop's pieces, then each stem's
    interior (hairpin, internal loop, or multiloop segments)."""
    n = pt.shape[0]
    stems, where = _stems(pt)
    els = [("stem", sorted(list(range(i, i + k + 1)) + list(range(j - k, j + 1))), [s])
           for s, (i, j, k) in enumerate(stems)]
    runs, top = _level(pt, 0, n - 1, where)
    if top:
        if runs[0]:
            els.append(("five_prime", runs[0], [top[0]]))
        for t in range(1, len(top)):
            els.append(("multiloop", runs[t], [top[t - 1], top[t]]))
        if runs[-1]:
            els.append(("three_prime", runs[-1], [top[-1]]))
    elif runs[0]:
        els.append(("five_prime", runs[0], []))
    for s, (i, j, k) in enumerate(stems):
        lo, hi = i + k + 1, j - k - 1
        if lo > hi:
            els.append(("hairpin", [], [s]))
            continue
        runs, inner = _level(pt, lo, hi, where)
        if not inner:
            els.append(("hairpin", runs[0], [s]))
        elif len(inner) == 1:
            els.append(("internal", sorted(runs[0] + runs[1]), [s, inner[0]]))
        else:
            els.append(("multiloop", runs[0], [s, inner[0]]))
            for t in range(1, len(inner)):
                els.append(("multiloop", runs[t], [inner[t - 1], inner[t]]))
            els.append(("multiloop", runs[-1], [inner[-1], s]))
    return els


def forgi_graph(structure: str) -> Graph:
    """Bases first (16-wide features: 4 structural, 4 sequence (zero: no
    sequence weight), ``is_base``, a 7-way element type), then one
    meta-node per element.  Edges: the base edges widened to 7 columns
    ``[adj, bp, meta->base, base->meta, meta<->meta, fwd, bwd]``; per
    element and member, meta -> base then base -> meta; per pair of
    connected elements ``a < b``, a -> b then b -> a."""
    pt = pair_table(structure)
    n = pt.shape[0]
    els = forgi_elements(pt)
    feat = np.zeros((n + len(els), 16), np.float32)
    feat[:n, :4] = node_features(pt, 4)
    feat[:n, 8] = 1.0
    for k, (kind, _, _) in enumerate(els):
        feat[n + k, 9 + FORGI_KINDS.index(kind)] = 1.0
    s0, d0, a4 = _base_edges(pt)
    a0 = np.zeros((s0.size, 7), np.float32)
    a0[:, :2] = a4[:, :2]
    a0[:, 5:] = a4[:, 2:]
    src, dst, col = [], [], []
    for k, (_, members, _) in enumerate(els):
        for m in members:
            src += [n + k, m]
            dst += [m, n + k]
            col += [2, 3]
    conns = sorted({tuple(sorted((e, s))) for e, (kind, _, touched) in enumerate(els)
                    if kind != "stem" for s in touched if s != e})
    for a, b in conns:
        src += [n + a, n + b]
        dst += [n + b, n + a]
        col += [4, 4]
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    a1 = np.zeros((src.size, 7), np.float32)
    a1[np.arange(src.size), col] = 1.0
    a1[:, 5] = (src < dst).astype(np.float32)
    a1[:, 6] = 1.0 - a1[:, 5]
    return Graph(feat, np.concatenate([s0, src]), np.concatenate([d0, dst]),
                 np.concatenate([a0, a1]), n)
