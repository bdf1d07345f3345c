"""Device-resident progressive alignment for library-mode scoring.

Port of ``ginfinity_tpu/ops/library_pool.py``.  The library score
matrix of a merge of profiles A and B,

    S[c, e] = (1 / nA nB) * sum over library pairs (x, y), x in A, y in B,
              of the posterior v[x-pos p, y-pos q] scattered at
              (column of p in A, column of q in B),

needs the posterior slabs, which the consistency stage leaves on the
device, and a position -> column map ``POS2COL [Npad, P]`` per member,
remapped through each merge's op codes.  Each library pair fires at one
merge, where its two members first share a profile, so the host can
schedule the whole run from the guide tree (:func:`build_library_schedule`)
and enqueue every step with no read-back: steps of ``_LIB_BW`` lanes,
each scattering one chunk of ``EC`` entries into a carried
``[_LIB_BW, P, P]`` accumulator, then (merge steps) the DP, the device
traceback and the ``POS2COL`` remap, and a reset.  The op codes and
lengths download once at the end.

The scatter is the bit-level crux.  JAX adds ``.at[].add`` on the CPU
one update after another, in update order, onto the carried
accumulator; the CPU's ``index_add_`` does the same.  On the card
``index_add_`` adds with atomics, in an order that changes from run to
run, and the accumulator is not zero (it carries across entry chunks),
so a sum of each cell's updates added to it afterwards would round
otherwise.  :func:`ordered_accumulate` keeps the sequential chain: the
updates are sorted stably by cell, each cell's current value is placed
first in its segment, and ``segment_reduce`` adds every segment in
order (2-D rows: the card adds each column of a 2-D run in order).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ginfinity_tpu_torch.ops.pairhmm import _pow2_batch, _profile_ops_device
from ginfinity_tpu_torch.ops.profile_pool import _member_capacity, compact_ops, enqueue_guard

# entries per accumulation chunk: bounds the [EC, Ls, k] gathers whatever
# the number of library pairs that fire at one merge
_ENTRY_CHUNK = 512
# lanes (merges) per step of the level schedule
_LIB_BW = 8


def _slab_capacity(t: int) -> int:
    """The slab count padded to a power of two (>= 64): what the entry
    width of the level schedule is keyed on."""
    return _pow2_batch(max(64, t))


def _entry_chunk_width(n_pairs: int) -> int:
    """The chunk width of :func:`accumulate_pair_scores` for a library of
    ``n_pairs`` pairs."""
    return _pow2_batch(min(_ENTRY_CHUNK, max(1, n_pairs)))


def _scan_entry_width(n_pairs: int) -> int:
    """Entries a step of the level schedule scatters: most levels carry
    few spanning pairs, so a narrow width with accumulate-only steps for
    the rest."""
    return min(_entry_chunk_width(n_pairs), 64)


def ordered_accumulate(S_flat: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> None:
    """``S_flat[idx[e]] += v[e]`` for ``e`` in order, in place: each cell's
    updates added one after another onto its current value, on any
    device.  The card's accumulation; equal to the CPU's ``index_add_``
    bit for bit."""
    ncell, E = S_flat.numel(), idx.numel()
    dev = S_flat.device
    sidx, perm = torch.sort(idx, stable=True)
    cells = torch.arange(ncell, device=dev)
    first = torch.searchsorted(sidx, cells)
    count = torch.searchsorted(sidx, cells, right=True) - first
    # each cell's current value, then its updates in order: cell c's value
    # at c + first[c], the k-th sorted update at k + sidx[k] + 1
    data = torch.zeros((ncell + E, 2), dtype=S_flat.dtype, device=dev)
    data[cells + first, 0] = S_flat
    data[torch.arange(E, device=dev) + sidx + 1, 0] = v[perm]
    out = torch.segment_reduce(data, "sum", lengths=count + 1, axis=0, unsafe=True)
    S_flat.copy_(out[:, 0])


def accumulate(S_flat: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> None:
    """Sequential scatter-add in place: ``index_add_`` on the CPU,
    :func:`ordered_accumulate` on the card."""
    if S_flat.is_cuda:
        ordered_accumulate(S_flat, idx, v)
    else:
        S_flat.index_add_(0, idx, v)


def _lib_accum(S, POS2COL, Cv, Ci, pair_a, pair_b, lane, t, flip, w):
    """Scatter one entry chunk into the level's score matrices ``S [Bp,
    P, P]`` in place.  ``Cv``/``Ci [T, Ls, k]``: the library slabs (slab
    t's owner position p matches partner position ``Ci[t, p, j]`` with
    posterior ``Cv[t, p, j]``); ``lane``/``t``/``flip``/``w [EC]``: which
    matrix, which slab, the owner's side (0: the A child, slab rows are S
    rows) and a 0/1 weight (0: padding)."""
    _, P, _ = S.shape
    Ls, K = Cv.shape[1], Cv.shape[2]
    EC = t.shape[0]
    v = Cv[t] * w[:, None, None]                               # [EC, Ls, k]
    ci = Ci[t].clamp(0, P - 1).reshape(EC, Ls * K).to(torch.int64)
    own_col = POS2COL[pair_a[t]][:, :Ls]                       # [EC, Ls]
    par_col = torch.gather(POS2COL[pair_b[t]], 1, ci).reshape(EC, Ls, K)
    oc = own_col[:, :, None].expand(EC, Ls, K)
    f = flip[:, None, None]
    # columns past P arise only once a merge has outgrown P, a run the host
    # discards as an overflow; clamped, they stay inside the accumulator
    r = torch.where(f == 0, oc, par_col).clamp(0, P - 1)
    c = torch.where(f == 0, par_col, oc).clamp(0, P - 1)
    flat = (lane[:, None, None] * P + r) * P + c
    accumulate(S.view(-1), flat.reshape(-1), v.reshape(-1))


def _lib_dp_merge(POS2COL, LN, S, blk, denom, mlane, mside, go, ge):
    """DP and traceback on the accumulated matrices, then every member's
    position -> column map remapped through its merge's codes.  ``blk
    [Bp, 3]`` (slotA, slotB, slotOut); ``denom [Bp]`` = nA nB; ``mlane
    [Npad]`` each member's lane; ``mside [Npad]`` 0 = in the A child, 1 =
    in B, 2 = idle.  Returns the new maps, the reverse-order codes and the
    merged lengths; ``LN`` is updated in place."""
    ia, ib, iout = blk[:, 0], blk[:, 1], blk[:, 2]
    P = POS2COL.shape[1]
    ops_rev = _profile_ops_device(S / denom[:, None, None], LN[ia], LN[ib], go, ge)
    opc, n, idx = compact_ops(ops_rev)
    idx = idx.expand_as(opc)
    zero = torch.zeros((), dtype=idx.dtype, device=idx.device)

    def col_map(takes):
        # old column -> merged column: each real old column is written once
        # (a value >= 0); padding steps write 0 by max, never above a real one
        to = torch.where(takes, (torch.cumsum(takes, dim=1) - 1).clamp(0, P - 1), P - 1)
        out = torch.zeros((opc.shape[0], P), dtype=idx.dtype, device=idx.device)
        return out.scatter_reduce_(1, to, torch.where(takes, idx, zero), "amax")

    mapA = col_map((opc == 0) | (opc == 1))
    mapB = col_map((opc == 0) | (opc == 2))
    cur = POS2COL.clamp(0, P - 1)
    remapA = torch.gather(mapA[mlane], 1, cur)
    remapB = torch.gather(mapB[mlane], 1, cur)
    side = mside[:, None]
    POS2COL = torch.where(side == 0, remapA, torch.where(side == 1, remapB, POS2COL))
    LN[iout] = n
    return POS2COL, ops_rev, n


def merge_ops_from_scores(S, denom, l1, l2, gap_open, gap_extend) -> list:
    """DP on accumulated score matrices ``S [B, P, P]`` divided by
    ``denom``, on ``S``'s device; only the op codes download.  Returns a
    list of forward-order op arrays (0 match, 1 gap-in-B, 2 gap-in-A)."""
    dev = S.device
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt).to(dev)  # noqa: E731
    ops = _profile_ops_device(S / t(denom, torch.float32)[:, None, None],
                              t(l1, torch.int64), t(l2, torch.int64),
                              gap_open, gap_extend).cpu().numpy()
    return [row[row != 3][::-1].copy() for row in ops]


def accumulate_pair_scores(Cv, Ci, pair_a, pair_b, pos2col, entries, P, n_lanes=1):
    """One level of merges' un-normalised ``[Bp, P, P]`` library matrices
    on the slabs' device, for the calls the level schedule does not cover
    (refinement realigns, the overflow fallback's levels).  ``entries``:
    ``[(lane, slab, flip)]``; ``pos2col [Npad, P]`` every member's current
    map (rows of members outside the level are never read)."""
    Bp = 1 if n_lanes == 1 else _pow2_batch(n_lanes)
    S = torch.zeros((Bp, P, P), dtype=torch.float32, device=Cv.device)
    if entries:
        _scatter_entry_chunks(S, pos2col, Cv, Ci, pair_a, pair_b, entries,
                              _entry_chunk_width(int(pair_a.shape[0])))
    return S


def _scatter_entry_chunks(S, POS2COL, Cv, Ci, pa, pb, entries, EC):
    """Scatter ``entries`` [(lane, slab, flip)] into ``S`` in EC-wide
    zero-padded chunks."""
    dev = S.device
    for s in range(0, len(entries), EC):
        chunk = np.zeros((4, EC), np.int64)
        part = np.asarray(entries[s:s + EC], np.int64).T
        chunk[:3, :part.shape[1]] = part
        chunk[3, :part.shape[1]] = 1
        lane, tid, flip, w = torch.from_numpy(chunk).to(dev)
        _lib_accum(S, POS2COL, Cv, Ci, pa, pb, lane, tid, flip, w.to(torch.float32))


def build_library_schedule(node_levels, slot_of, n_internal_offset, pairs, n_seq, members_of):
    """Host-side static schedule: which library pair fires at which
    (level, lane, orientation), plus per-level member remap tables.

    ``node_levels``: the levelized internal nodes (``pipelines/msa.py::
    _build_levels``); ``slot_of(node)`` the pool slot of a leaf or an
    internal node; ``pairs``: the library's (a, b) list; ``members_of``:
    node -> list of member indices.  Each pair fires exactly once, at the
    merge where its two members first share a profile."""
    pending = {tid: ab for tid, ab in enumerate(pairs)}
    comp = {m: ("leaf", m) for m in range(n_seq)}
    schedule = []
    for lv in node_levels:
        lanes = []
        entries = []
        mlane = np.zeros(n_seq, np.int32)
        mside = np.full(n_seq, 2, np.int32)
        key_to_lane_side = {}
        for lane_i, node in enumerate(lv):
            a_child, b_child = node[0], node[1]
            ka = comp[members_of(a_child)[0]]
            kb = comp[members_of(b_child)[0]]
            key_to_lane_side[ka] = (lane_i, 0)
            key_to_lane_side[kb] = (lane_i, 1)
            na, nb = len(members_of(a_child)), len(members_of(b_child))
            lanes.append((slot_of(a_child), slot_of(b_child), slot_of(node), float(na * nb)))
            for m in members_of(a_child):
                mlane[m], mside[m] = lane_i, 0
            for m in members_of(b_child):
                mlane[m], mside[m] = lane_i, 1
        done = []
        for tid, (a, b) in pending.items():
            la = key_to_lane_side.get(comp[a])
            lb = key_to_lane_side.get(comp[b])
            if la is None or lb is None or la[0] != lb[0] or la[1] == lb[1]:
                continue
            # owner (slab row side) = a; flip when a sits in the B child,
            # the rule of PosteriorLibrary._accumulate_device too
            entries.append((la[0], tid, 1 if la[1] == 1 else 0))
            done.append(tid)
        for tid in done:
            del pending[tid]
        for node in lv:
            key = ("node", id(node))
            for m in members_of(node):
                comp[m] = key
        schedule.append((lanes, entries, mlane, mside))
    return schedule


def run_library_pool(schedule, Cv, Ci, pair_a, pair_b, leaf_len, n_internal, P,
                     gap_open, gap_extend, stats=None):
    """Run a library-mode level schedule on the slabs' device.

    Returns (ops_per_level, lengths_per_level) as host arrays, or ``None``
    on overflow (a merge outgrew P): the caller then falls back.
    ``stats``, when given, receives the enqueue seconds, the
    device-plus-download seconds, the levels and the steps."""
    dev = Cv.device
    N = len(leaf_len)
    if Cv.shape[1] > P:
        return None  # slab rows would not map
    Npad = _member_capacity(N)
    shift = Npad - N
    M = 2 * Npad
    dump = M - 1
    if N + n_internal + 1 > M:
        return None
    EC = _scan_entry_width(_slab_capacity(len(pair_a)))
    BW = _LIB_BW

    def _slot(s):
        return s if s < N else s + shift

    # the flat step plan: each level in lane groups of BW, each group's
    # entries in EC-wide chunks, all but the last accumulate-only
    steps = []
    level_layout: list[list[tuple[int, int]]] = []
    n_merges = 0
    for lanes, entries, mlane, mside in schedule:
        groups = []
        for g0 in range(0, len(lanes), BW):
            glanes = lanes[g0:g0 + BW]
            gent = [(ln - g0, tt, fl) for (ln, tt, fl) in entries if g0 <= ln < g0 + BW]
            chunks = [gent[s:s + EC] for s in range(0, len(gent), EC)] or [[]]
            for ch in chunks[:-1]:
                steps.append((None, None, None, None, ch))
            blk = np.full((BW, 3), (0, 0, dump), np.int64)
            denom = np.ones(BW, np.float32)
            for i, (sa, sb, so, dn) in enumerate(glanes):
                blk[i] = (_slot(sa), _slot(sb), _slot(so))
                denom[i] = dn
            g_mlane = np.zeros(Npad, np.int64)
            g_mside = np.full(Npad, 2, np.int64)
            in_g = (mside != 2) & (mlane >= g0) & (mlane < g0 + BW)
            g_mlane[:N][in_g] = mlane[in_g] - g0
            g_mside[:N][in_g] = mside[in_g]
            steps.append((blk, denom, g_mlane, g_mside, chunks[-1]))
            groups.append((n_merges, len(glanes)))
            n_merges += 1
        level_layout.append(groups)

    n_steps = len(steps)
    blks = np.broadcast_to(np.asarray((0, 0, dump), np.int64), (n_merges, BW, 3)).copy()
    denoms = np.ones((n_merges, BW), np.float32)
    mlanes = np.zeros((n_merges, Npad), np.int64)
    msides = np.full((n_merges, Npad), 2, np.int64)
    ent = np.zeros((n_steps, 3, EC), np.int64)
    ws = np.zeros((n_steps, EC), np.float32)
    plan = []  # per step: (scatters?, merge index or None)
    mi = 0
    for t, (blk, denom, g_mlane, g_mside, ch) in enumerate(steps):
        if ch:
            ent[t, :, :len(ch)] = np.asarray(ch, np.int64).T
            ws[t, :len(ch)] = 1.0
        if blk is not None:
            blks[mi], denoms[mi], mlanes[mi], msides[mi] = blk, denom, g_mlane, g_mside
            plan.append((bool(ch), mi))
            mi += 1
        else:
            plan.append((True, None))

    up = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    pa, pb = up(np.asarray(pair_a, np.int64)), up(np.asarray(pair_b, np.int64))
    blks_d, denoms_d, mlanes_d, msides_d = up(blks), up(denoms), up(mlanes), up(msides)
    ent_d, ws_d = up(ent), up(ws)
    POS2COL = torch.arange(P, device=dev).repeat(Npad, 1)  # identity maps
    LN = torch.zeros(M, dtype=torch.int64, device=dev)
    LN[:N] = up(np.asarray(leaf_len, np.int64))
    S = torch.zeros((BW, P, P), dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    ops_out, len_out = [], []
    with enqueue_guard(dev):
        for t, (scatters, m) in enumerate(plan):
            if scatters:
                _lib_accum(S, POS2COL, Cv, Ci, pa, pb, ent_d[t, 0], ent_d[t, 1],
                           ent_d[t, 2], ws_d[t])
            if m is not None:
                POS2COL, ops_rev, n_new = _lib_dp_merge(
                    POS2COL, LN, S, blks_d[m], denoms_d[m], mlanes_d[m], msides_d[m],
                    gap_open, gap_extend)
                ops_out.append(ops_rev)
                len_out.append(n_new)
                S.zero_()
        ops_d, len_d = torch.stack(ops_out), torch.stack(len_out)
    t1 = time.perf_counter()
    ops_all, len_all = ops_d.cpu().numpy(), len_d.cpu().numpy()  # the run's one download
    t2 = time.perf_counter()
    if stats is not None:
        stats.update(enqueue_s=t1 - t0, device_download_s=t2 - t1, levels=len(schedule),
                     steps=n_steps)

    ops_host = [np.concatenate([ops_all[m][:w] for m, w in groups]) for groups in level_layout]
    lengths = [np.concatenate([len_all[m][:w] for m, w in groups]) for groups in level_layout]
    if any(int(ln.max(initial=0)) > P for ln in lengths):
        return None  # overflow -> the caller's fallback
    return ops_host, lengths
