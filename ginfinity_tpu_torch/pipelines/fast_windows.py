"""Sliding-window embedding on the device — the scale path for window
corpora (port of ``ginfinity_tpu/pipelines/fast_windows.py``).

Each structure's full feature and pair arrays go to the device once;
every window is then built there by index arithmetic and run through
the encoder.  Window semantics are those of the JAX package's
``windows.slice_window``: keep-paired-neighbors pull-in, backbone cuts
and the adjacent-pair quirk.

Layout (the ALIGNED layout of the JAX package): 2L slots per window;
slot ``i < L`` holds position ``start + i`` and slot ``L + i`` holds
position ``i``'s pulled outside partner (masked when absent).  Backbone
and pulled-partner messages are shifts, in-window base-pair messages a
row gather, and the edge-attr embeddings constant rows.  The encoder of
a chunk is :func:`ginfinity_tpu_torch.ops.windows_encoder.forward_windows`
(the CUDA kernel on the card) for the configs its gate covers, and the
plain torch encoder for the other dense configs.

Configs outside the dense forward (batch, layer or instance norm,
Set2Set, edges neither 4 nor 7 wide) take the compact path: each chunk
of windows becomes one flat batch of window graphs, built on the device
(:func:`_window_graphs`, the JAX package's ``_window_batch``,
``_compact`` and ``_flatten_window_chunk`` in one step), with exactly the
window's nodes and edges and no padding, and runs through the model's
``forward_once``.  Chunks are cut from exact host counts of each
window's nodes (:func:`_window_slot_counts`); the JAX package's slot
caps and their ladder exist only to bound XLA's recompiles.

Structures are grouped by padded length (the capacity ladder), each
group's arrays stacked into one ``[S, n_cap]`` upload, and the group's
windows embedded chunk by chunk from flat (structure, start)
descriptors.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.batching import GraphBatch, _round_capacity
from ginfinity_tpu_torch.graphs.build import window_node_features
from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, _dense, forward_once
from ginfinity_tpu_torch.ops.windows_encoder import (
    forward_windows,
    forward_windows_reference,
    windows_kernel_ok,
)
from ginfinity_tpu_torch.pipelines.windows import window_starts_mask
from ginfinity_tpu_torch.utils.device import disable_tf32, resolve_device


# real nodes per chunk of the compact path
_COMPACT_CHUNK_NODES = 32768


def _chunk_for(w_cap: int) -> int:
    """Largest of {128, 64, 32} dividing the padded window count (every
    ladder capacity is a multiple of 32)."""
    for c in (128, 64, 32):
        if w_cap % c == 0:
            return c
    return 32


def _dense_forward_ok(config: GINConfig) -> bool:
    """The dense chunk forward covers the window pipeline's config space:
    4- or 7-dim edges, graph/none norm, add/mean pooling."""
    return (
        config.edge_feature_dim in (4, 7)
        and config.norm_type in ("graph", "none")
        and config.pooling_type in ("global_add_pool", "global_mean_pool")
    )


def _window_chunk(config: GINConfig, params: dict, feats_all: torch.Tensor,
                  pts_all: torch.Tensor, si: torch.Tensor, st: torch.Tensor,
                  L: int, keep_paired_neighbors: bool = True, views=None):
    """Build a chunk of windows in the aligned layout and run the node
    encoder.  ``feats_all [S, n_cap, F]`` / ``pts_all [S, n_cap]`` (int64)
    are a group's stacked structures, ``si``/``st [C]`` (int64) the
    windows' structure slots and starts.  ``views`` are the sliding
    views ``(feats_all.unfold(1, L, 1), pts_all.unfold(1, L, 1))``: one
    contiguous row per window instead of C*L element gathers.

    Returns ``x0 [C, 2L, h0]`` and the encoder's window flags
    ``(j_local int32, bp_in, pulled, fwd_into_w, fwd_into_p)``, each
    ``[C, L]``."""
    f32 = torch.float32
    dev = feats_all.device
    C = si.shape[0]
    idx = st[:, None] + torch.arange(L, device=dev)[None, :]        # [C, L]
    if views is not None:
        fview, pview = views
        fw = fview[si, st].transpose(1, 2)                          # [C, L, F]
        partner = pview[si, st]                                     # [C, L]
    else:
        partner = pts_all[si[:, None], idx]
        fw = feats_all[si[:, None], idx]
    pfeat = feats_all[si[:, None], partner.clamp(min=0)]            # [C, L, F]
    has = partner >= 0
    adj = (partner - idx).abs() == 1    # reference adjacent-pair quirk
    bp_real = has & ~adj
    in_win = (partner >= st[:, None]) & (partner < st[:, None] + L)
    if keep_paired_neighbors:
        pulled = (bp_real & ~in_win).to(f32)
    else:
        pulled = torch.zeros((C, L), dtype=f32, device=dev)
    bp_in = (bp_real & in_win).to(f32)
    j_local = (partner - st[:, None]).clamp(0, L - 1).to(torch.int32)
    # is_forward of the message arriving at each node (src < dst in
    # original coordinates): at window position i from partner j, j < i
    fwd_into_w = (partner < idx).to(f32)
    # at the pulled slot (holding j) from its puller i: i < j
    fwd_into_p = (idx < partner).to(f32)

    node_feat = torch.cat([fw, pfeat * pulled[..., None]], dim=1)
    x0 = _dense(node_feat.reshape(C * 2 * L, -1), params["node_encoder"])
    return x0.reshape(C, 2 * L, -1), (j_local, bp_in, pulled, fwd_into_w, fwd_into_p)


def _forward_windows_aligned(config: GINConfig, params: dict, state: dict,
                             feats_all: torch.Tensor, pts_all: torch.Tensor,
                             si: torch.Tensor, st: torch.Tensor, L: int,
                             keep_paired_neighbors: bool = True, views=None,
                             use_kernel: bool | None = None, packed=None) -> torch.Tensor:
    """Fused build + GINE forward of a chunk of windows: ``[C, out_dim]``.

    ``use_kernel=None`` takes the window encoder (the CUDA kernel for
    CUDA tensors) exactly for the configs its gate covers; the others,
    and ``use_kernel=False``, take the plain torch encoder."""
    x0, flags = _window_chunk(config, params, feats_all, pts_all, si, st, L,
                              keep_paired_neighbors, views)
    if use_kernel is None:
        use_kernel = windows_kernel_ok(config)
    if use_kernel:
        return forward_windows(config, params, state, x0, *flags, L, packed=packed)
    return forward_windows_reference(config, params, state, x0, *flags, L)


def _window_slot_counts(pt: np.ndarray, L: int, starts: np.ndarray,
                        keep_paired_neighbors: bool) -> tuple[np.ndarray, np.ndarray]:
    """Per window of ``starts``, exact: (in-window base pairs, pulled
    partners), from one O(n) interval-sum sweep on the host."""
    n = pt.shape[0]
    ns = n - L + 1
    i = np.arange(n)
    up = (pt >= 0) & (np.abs(pt - i) != 1) & (pt > i)
    ii, jj = i[up], pt[up].astype(np.int64)

    def interval_counts(lo, hi):
        diff = np.zeros(ns + 1, np.int64)
        lo, hi = np.maximum(lo, 0), np.minimum(hi, ns - 1)
        ok = lo <= hi
        np.add.at(diff, lo[ok], 1)
        np.add.at(diff, hi[ok] + 1, -1)
        return np.cumsum(diff[:ns])

    # pair (i, j) wholly in window [s, s+L): s in [j-L+1, i]
    bp = interval_counts(jj - L + 1, ii)
    pulled = np.zeros(ns, np.int64)
    if keep_paired_neighbors and ii.size:
        # i in the window, j above it: s in [i-L+1, min(i, j-L)]
        pulled = interval_counts(ii - L + 1, np.minimum(ii, jj - L))
        # j in the window, i below it: s in [max(i+1, j-L+1), j]
        pulled = pulled + interval_counts(np.maximum(ii + 1, jj - L + 1), jj)
    return bp[starts], pulled[starts]


def _both_ways(src, dst, fwd, attr2, edge_dim: int):
    """Edges ``src -> dst`` with forward flags ``fwd``, then their reverses;
    attributes ``[attr2, zeros, is_forward, is_backward]``, ``edge_dim``
    wide."""
    s = torch.cat([src, dst])
    d = torch.cat([dst, src])
    f = torch.cat([fwd, 1.0 - fwd])[:, None]
    attr = torch.zeros((s.shape[0], edge_dim), dtype=torch.float32, device=src.device)
    attr[:, :2] = torch.as_tensor(attr2, dtype=torch.float32, device=src.device)
    attr[:, -2:] = torch.cat([f, 1.0 - f], dim=1)
    return s, d, attr


def _window_graphs(config: GINConfig, feats_all: torch.Tensor, pts_all: torch.Tensor,
                   si: torch.Tensor, st: torch.Tensor, L: int,
                   keep_paired_neighbors: bool) -> GraphBatch:
    """A chunk of ``C`` windows as one flat batch of ``C`` window graphs,
    built on the device with no padding.  Window ``c``'s positions are
    nodes ``c*L .. c*L+L-1``; the pulled partners follow all of them, in
    (window, position) order.  Edges: backbone ``(i, i-1)``, in-window
    base pairs ``(i, j)`` with ``i < j``, and each pulled pair ``(i,
    partner slot)``, each followed by its reverse.  Graph pooling and the
    norms are node-order invariant, so this is the JAX package's
    ``_window_batch`` up to node order."""
    dev = feats_all.device
    C = si.shape[0]
    pos = torch.arange(L, device=dev)
    idx = st[:, None] + pos[None, :]                                 # [C, L]
    partner = pts_all[si[:, None], idx]
    bp_real = (partner >= 0) & ((partner - idx).abs() != 1)
    in_win = (partner >= st[:, None]) & (partner < st[:, None] + L)
    base = (torch.arange(C, device=dev) * L)[:, None] + pos[None, :]  # node of (c, i)

    pc, pi = (bp_real & ~in_win).nonzero(as_tuple=True) if keep_paired_neighbors else \
        (pos[:0], pos[:0])
    pulled_node = C * L + torch.arange(pc.shape[0], device=dev)
    node_feat = torch.cat([feats_all[si[:, None], idx].reshape(C * L, -1),
                           feats_all[si[pc], partner[pc, pi]]])
    node_graph = torch.cat([torch.arange(C, device=dev).repeat_interleave(L), pc])

    bb_src = base[:, 1:].reshape(-1)
    bc, bi = (bp_real & in_win & (partner > idx)).nonzero(as_tuple=True)
    f32 = torch.float32
    segs = [
        _both_ways(bb_src, bb_src - 1, torch.zeros_like(bb_src, dtype=f32), (1.0, 0.0),
                   config.edge_feature_dim),
        _both_ways(base[bc, bi], base[bc, partner[bc, bi] - st[bc]],
                   torch.ones_like(bc, dtype=f32), (0.0, 1.0), config.edge_feature_dim),
        _both_ways(base[pc, pi], pulled_node, (idx[pc, pi] < partner[pc, pi]).to(f32),
                   (0.0, 1.0), config.edge_feature_dim),
    ]
    edge_src = torch.cat([sg[0] for sg in segs]).to(torch.int32)
    n_nodes = node_graph.shape[0]
    return GraphBatch(
        node_feat=node_feat,
        node_graph=node_graph.to(torch.int32),
        node_mask=torch.ones(n_nodes, dtype=f32, device=dev),
        base_mask=torch.ones(n_nodes, dtype=f32, device=dev),
        edge_src=edge_src,
        edge_dst=torch.cat([sg[1] for sg in segs]).to(torch.int32),
        edge_attr=torch.cat([sg[2] for sg in segs]),
        edge_mask=torch.ones(edge_src.shape[0], dtype=f32, device=dev),
        n_nodes=torch.bincount(node_graph, minlength=C).to(torch.int32),
        num_graphs=C,
    )


def _prep_corpus_groups(cfg: GINConfig, structures, L: int, keep_paired_neighbors: bool,
                        mask_threshold: float, max_programs: int | None = None):
    """Host preprocessing and capacity-ladder grouping.  Returns
    ``(per, groups)``: ``per[i] = (n_cap, feat, pt, n, starts)`` or None
    for a structure without windows, ``groups[n_cap]`` the structures of
    one rung.  ``max_programs`` merges the smallest rungs upward until
    at most that many remain."""
    per = [None] * len(structures)
    for i, s in enumerate(structures):
        pt = pair_table(s)
        n = pt.shape[0]
        if n < L:
            continue
        keep = window_starts_mask(s, L, mask_threshold)
        starts = np.nonzero(keep)[0].astype(np.int32)
        if starts.size == 0:
            continue
        feat = window_node_features(
            pt, None, cfg.seq_weight, cfg.graph_encoding, cfg.node_feature_dim
        )
        per[i] = (_round_capacity(n), feat, pt, n, starts)

    groups: dict[int, list[int]] = {}
    for i, item in enumerate(per):
        if item is not None:
            groups.setdefault(item[0], []).append(i)
    if max_programs and len(groups) > max_programs:
        items = sorted(groups.items())
        while len(items) > max_programs:
            (_, i0), (nc1, i1) = items[0], items[1]
            items = sorted([(nc1, i0 + i1)] + items[2:])
        groups = dict(items)
    return per, groups


def _pack_group(cfg: GINConfig, per, n_cap: int, idxs, w_multiple: int | None = None):
    """Stacked padded arrays and window descriptors of one ladder group:
    ``(feats, pts, sidx, starts, w_cap)``.  The descriptors are padded to
    ``w_cap`` with (slot 0, start 0), a valid window."""
    s_cap = _round_capacity(len(idxs))
    feats = np.zeros((s_cap, n_cap, cfg.node_feature_dim), np.float32)
    pts_p = np.full((s_cap, n_cap), -1, np.int32)
    sidx_parts, starts_parts = [], []
    for local, i in enumerate(idxs):
        _, feat, pt, n, starts = per[i]
        feats[local, :n] = feat
        pts_p[local, :n] = pt
        sidx_parts.append(np.full(starts.size, local, np.int32))
        starts_parts.append(starts)
    sidx = np.concatenate(sidx_parts)
    starts_all = np.concatenate(starts_parts)
    w_cap = _round_capacity(sidx.size)
    if w_multiple:
        w_cap = -(-w_cap // w_multiple) * w_multiple
    sidx_p = np.zeros(w_cap, np.int32)
    sidx_p[: sidx.size] = sidx
    starts_p = np.zeros(w_cap, np.int32)
    starts_p[: starts_all.size] = starts_all
    return feats, pts_p, sidx_p, starts_p, w_cap


def _upload_group(cfg: GINConfig, per, n_cap: int, idxs, dev):
    """One ladder group's stacked arrays and its real window descriptors on
    ``dev``: ``(feats, pts, si, st, w_cap)``."""
    feats, pts_p, sidx_p, starts_p, w_cap = _pack_group(cfg, per, n_cap, idxs)
    n_real = sum(per[i][4].size for i in idxs)
    return (torch.from_numpy(feats).to(dev), torch.from_numpy(pts_p).to(dev, torch.int64),
            torch.from_numpy(sidx_p[:n_real]).to(dev, torch.int64),
            torch.from_numpy(starts_p[:n_real]).to(dev, torch.int64), w_cap)


def _embed_group(model: GINModel, per, n_cap: int, idxs, L: int,
                 keep_paired_neighbors: bool, use_kernel: bool | None = None) -> torch.Tensor:
    """Every window of one ladder group, on the model's device:
    ``[n_windows, out_dim]`` in descriptor order.  Chunks run over the
    real descriptors only; the padding of ``w_cap`` sets the chunk size."""
    cfg = model.config
    dev = model.device
    feats_d, pts_d, si, st, w_cap = _upload_group(cfg, per, n_cap, idxs, dev)
    n_real = si.shape[0]
    views = (feats_d.unfold(1, L, 1), pts_d.unfold(1, L, 1))
    params, state = model.params, model.state
    kernel = use_kernel if use_kernel is not None else windows_kernel_ok(cfg)
    packed = model.packed_windows() if kernel and dev.type == "cuda" else None
    chunk = _chunk_for(w_cap)
    out = torch.empty((n_real, cfg.output_dim), dtype=torch.float32, device=dev)
    for c0 in range(0, n_real, chunk):
        out[c0:c0 + chunk] = _forward_windows_aligned(
            cfg, params, state, feats_d, pts_d, si[c0:c0 + chunk], st[c0:c0 + chunk],
            L, keep_paired_neighbors, views, kernel, packed,
        )
    return out


def _embed_group_compact(model: GINModel, per, n_cap: int, idxs, L: int,
                         keep_paired_neighbors: bool) -> torch.Tensor:
    """The compact path over one ladder group: ``[n_windows, out_dim]`` in
    descriptor order, chunks of at most about ``_COMPACT_CHUNK_NODES``
    real nodes."""
    cfg, dev = model.config, model.device
    feats_d, pts_d, si, st, _ = _upload_group(cfg, per, n_cap, idxs, dev)
    nodes = np.concatenate([
        L + _window_slot_counts(per[i][2], L, per[i][4], keep_paired_neighbors)[1]
        for i in idxs])
    n_real = nodes.size
    cuts = np.flatnonzero(np.diff(np.cumsum(nodes) // _COMPACT_CHUNK_NODES)) + 1
    bounds = np.concatenate([[0], cuts, [n_real]])
    params, state = model.params, model.state
    out = torch.empty((n_real, cfg.output_dim), dtype=torch.float32, device=dev)
    for c0, c1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        batch = _window_graphs(cfg, feats_d, pts_d, si[c0:c1], st[c0:c1], L,
                               keep_paired_neighbors)
        out[c0:c1] = forward_once(cfg, params, state, batch)
    return out


def embed_corpus_windows(model: GINModel, structures, L: int, keep_paired_neighbors=True,
                         mask_threshold=0.0, max_programs=None, mesh=None, wire=None,
                         device=None):
    """Window embeddings for a corpus: a list of ``(starts, embeddings)``
    per structure, as numpy arrays.

    ``device``: where to run (``None`` = the CUDA device; ``"cpu"`` only
    when asked); the model is moved there.  ``max_programs``: merge the
    smallest length buckets until at most this many groups remain.
    ``wire``: ``None``/"f32" returns exact float32; "f16" casts on the
    device and upcasts on the host (half the download for at most 2^-11
    relative rounding per element)."""
    if wire not in (None, "f32", "f16"):
        raise ValueError(f"wire must be None, 'f32' or 'f16', got {wire!r}")
    if mesh is not None:
        raise NotImplementedError(
            "multi-device window embedding is not ported yet (ROADMAP queue 1, item 11)"
        )
    cfg = model.config
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    if model.device != dev:
        model.to(dev)
    empty = (np.zeros(0, np.int64), np.zeros((0, cfg.output_dim), np.float32))
    per, groups = _prep_corpus_groups(
        cfg, structures, L, keep_paired_neighbors, mask_threshold, max_programs
    )
    results = [empty] * len(structures)
    embed_group = _embed_group if _dense_forward_ok(cfg) else _embed_group_compact
    for n_cap, idxs in groups.items():
        emb = embed_group(model, per, n_cap, idxs, L, keep_paired_neighbors)
        if wire == "f16":
            emb = emb.to(torch.float16)
        emb_np = emb.cpu().numpy().astype(np.float32, copy=False)
        off = 0
        for i in idxs:
            starts = per[i][4]
            results[i] = (starts.astype(np.int64), emb_np[off:off + starts.size])
            off += starts.size
    return results


def embed_structure_windows(model: GINModel, structure: str, L: int,
                            keep_paired_neighbors: bool = True, mask_threshold: float = 0.0,
                            device=None) -> tuple[np.ndarray, np.ndarray]:
    """All window embeddings of one structure: ``(starts [W] int64,
    embeddings [W, out_dim] float32)``, empty when the structure is
    shorter than ``L`` or every window is masked."""
    return embed_corpus_windows(model, [structure], L, keep_paired_neighbors, mask_threshold,
                                device=device)[0]
