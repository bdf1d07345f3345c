"""Device-resident progressive alignment: the profile pool.

Port of ``ginfinity_tpu/ops/profile_pool.py``.  The host-driven
progressive stage (``pipelines/msa.py::msa_from_tree`` under
``GINFINITY_MSA_POOL=0``) scores, downloads the dense DP states, traces
back and merges on the host at every tree level.  The pool keeps the
merge state on the device instead: profile tensors ``MU [M, P, d]``
(mean-structure embeddings), ``MB`` (base embeddings), ``ST`` (stem
fractions), ``LN`` (lengths); M = 2 Npad slots, leaves in ``[0, N)``,
internal nodes from ``Npad``, the last slot the dump of batch padding.
Each level gathers both children of every ready merge, runs the profile
DP (the reference-exact one, or under ``GINFINITY_PROFILE_DP=fast`` the
fast DP on product scores plus the 0.2 stem term), traces back on the
device (``ops/value_traceback.py``), merges with the cumsum gathers of
``_merge_from_ops`` and scatters the result into its slot.  Nothing is
read back inside the level loop: the host enqueues every level, then
downloads the op codes and lengths once and replays them on the host
for the aligned rows.

A merge may outgrow the padded length P; the lengths are checked after
the download and the run returns ``None``, and the caller falls back to
the host path.  JAX's scan of batch-1 tail chunks (``_pool_tail``) and
its program prewarm are XLA dispatch machinery: here those levels run
as consecutive batch-1 steps.

Row norms of the merged means are sums of the d squares in order, one
float32 add per term, so the card and the CPU compute the same bits
(a reduction kernel sums in another order on each).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.batching import _round_capacity
from ginfinity_tpu_torch.ops.pairhmm import (
    _comp_bonus,
    _pow2_batch,
    _profile_ops_device,
    _profile_ops_exact_device,
)
from ginfinity_tpu_torch.utils.device import resolve_device

# Set by a caller that checks the pools' enqueue loops for synchronisation
# (chip_smoke.py): each loop then runs under
# torch.cuda.set_sync_debug_mode("error") up to its one download, and
# ``guarded_loops`` counts the loops that ran so.  Both pools use it.
check_no_sync = False
guarded_loops = 0


@contextlib.contextmanager
def enqueue_guard(dev: torch.device):
    """The pools' enqueue loops run inside this: with ``check_no_sync`` on
    a CUDA device, any synchronisation in them raises."""
    global guarded_loops
    if not (check_no_sync and dev.type == "cuda"):
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    guarded_loops += 1


def pool_padded_len(max_leaf_len: int) -> int:
    """Padded profile length P of a pool run: >= 12.5% headroom over the
    longest leaf before rounding, so a family on a ladder rung does not
    overflow at its first gapped merge."""
    m = max(2, max_leaf_len)
    return _round_capacity(m + max(8, m // 8))


def library_pool_padded_len(max_leaf_len: int) -> int:
    """Padded profile length of a library-mode pool run: 25% headroom
    (library-scored merges are gap-heavier); ``pipelines/msa.py`` retries
    one rung higher on overflow."""
    m = max(2, max_leaf_len)
    return _round_capacity(m + max(8, m // 4))


def _member_capacity(n: int) -> int:
    """The member dimension padded to a power of two (>= 8); padded
    members are idle at every level."""
    return _pow2_batch(max(8, n))


def seq_row_norm(x: torch.Tensor) -> torch.Tensor:
    """``||x||`` over the last dim, keepdim, as ``sqrt`` of the squares
    added one after another in float32 (the same bits on every device)."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return s.sqrt()[..., None]


def compact_ops(ops_rev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse-order codes ``[B, T]`` (3 = padding) to forward order with
    the real codes first: ``(opc [B, T], n [B], idx [T])``, ``opc`` 3 past
    each merge's ``n`` codes."""
    B, T = ops_rev.shape
    opf = ops_rev.flip(1)  # forward order; the padding 3s form a prefix
    n = (opf != 3).sum(dim=1)
    idx = torch.arange(T, device=ops_rev.device)
    src = (idx[None, :] + (T - n)[:, None]).clamp(0, T - 1)
    opc = torch.where(idx[None, :] < n[:, None], torch.gather(opf, 1, src),
                      torch.full((), 3, dtype=opf.dtype, device=opf.device))
    return opc, n, idx


def _merge(ops_rev, Amu, Bmu, Ast, Bst, Abase, Bbase, P):
    """The vectorised ``merge_one`` of every merge of a level: merged
    means, stems, base means ``[B, P, ...]`` and lengths ``[B]``."""
    opc, n, idx = compact_ops(ops_rev)
    takes_a = (opc == 0) | (opc == 1)
    takes_b = (opc == 0) | (opc == 2)
    match = opc == 0
    ia_c = (torch.cumsum(takes_a, dim=1) - 1).clamp(0, P - 1)
    jb_c = (torch.cumsum(takes_b, dim=1) - 1).clamp(0, P - 1)
    ta = takes_a[:, :, None].to(torch.float32)
    tb = takes_b[:, :, None].to(torch.float32)

    def rows(X, c):
        return torch.gather(X, 1, c[:, :, None].expand(-1, -1, X.shape[2]))

    summed = rows(Amu, ia_c) * ta + rows(Bmu, jb_c) * tb  # [B, T, d]
    normed = summed / (seq_row_norm(summed) + 1e-8)
    mu = torch.where(match[:, :, None], normed, summed)
    stem = (torch.gather(Ast, 1, ia_c) * takes_a + torch.gather(Bst, 1, jb_c) * takes_b) \
        / torch.clamp(ta[:, :, 0] + tb[:, :, 0], min=1.0)
    live = (idx[None, :] < n[:, None])[:, :, None].to(torch.float32)
    mb = None
    if Abase is not None:
        sb = rows(Abase, ia_c) * ta + rows(Bbase, jb_c) * tb
        nb = sb / (seq_row_norm(sb) + 1e-8)
        mb = torch.where(match[:, :, None], nb, sb)[:, :P] * live[:, :P]
    mu = (mu * live)[:, :P]
    stem = (stem * live[:, :, 0])[:, :P]
    return mu, stem, mb, n


def _pool_level(MU, MB, ST, LN, blk, go, ge, sw, has_base, exact=True):
    """One tree level on the pool, in place: gather the children of the
    level's ``[Bp, 3]`` (ia, ib, iout) rows, score, DP, trace back, merge
    and scatter into the output slots.  Returns the reverse-order codes
    ``[Bp, 2P]`` and the merged lengths ``[Bp]``, on the device."""
    ia, ib, iout = blk[:, 0], blk[:, 1], blk[:, 2]
    P = MU.shape[1]
    A, Bm = MU[ia], MU[ib]
    stA, stB = ST[ia], ST[ib]
    l1, l2 = LN[ia], LN[ib]
    MBA = MB[ia] if has_base else None
    MBB = MB[ib] if has_base else None
    if exact:
        kw = {"MBA": MBA, "MBB": MBB, "sw": sw} if has_base else {}
        ops_rev = _profile_ops_exact_device(A, Bm, stA, stB, l1, l2, go, ge, **kw)
    else:
        S = torch.bmm(A, Bm.transpose(1, 2))
        if has_base:
            w = np.float32(sw)
            S = float(np.float32(1.0) - w) * S + float(w) * torch.bmm(MBA, MBB.transpose(1, 2))
        S = S + _comp_bonus(stA, stB)
        ops_rev = _profile_ops_device(S, l1, l2, go, ge)
    mu, stem, mb, n = _merge(ops_rev, A, Bm, stA, stB, MBA, MBB, P)
    MU[iout] = mu
    ST[iout] = stem
    if has_base:
        MB[iout] = mb
    LN[iout] = n
    return ops_rev, n


def run_progressive_pool(levels, leaf_mu, leaf_base, leaf_stem, leaf_len, P,
                         gap_open, gap_extend, seq_weight, exact=True, device=None,
                         stats=None):
    """Run the level schedule on a device-resident pool.

    ``levels``: list of (ia, ib, iout) int arrays of slots (leaves in
    ``[0, N)``, internal nodes in ``[N, 2N - 1)``).  ``leaf_*``: ``[N, ...]``
    host arrays padded to P.  Runs on ``device`` (the card unless the CPU
    is asked for).  Returns (ops_per_level, lengths_per_level) as host
    arrays, or ``None`` on overflow.  ``stats``, when given,
    receives the enqueue seconds, the device-plus-download seconds, the
    levels and the steps."""
    dev = resolve_device(device)
    N, d = leaf_mu.shape[0], leaf_mu.shape[2]
    Npad = _member_capacity(N)
    shift = Npad - N
    M = 2 * Npad
    dump = M - 1
    levels = [tuple(np.where(a >= N, a + shift, a).astype(np.int64) for a in lv)
              for lv in levels]
    has_base = leaf_base is not None

    def pool(leaf, tail):
        out = torch.zeros((M,) + tail, dtype=torch.float32, device=dev)
        out[:N] = torch.from_numpy(np.ascontiguousarray(leaf, np.float32)).to(dev)
        return out

    MU = pool(leaf_mu, (P, d))
    MB = pool(leaf_base, (P, leaf_base.shape[2])) if has_base else None
    ST = pool(leaf_stem, (P,))
    LN = torch.zeros(M, dtype=torch.int64, device=dev)
    LN[:N] = torch.from_numpy(np.asarray(leaf_len, np.int64)).to(dev)

    # batch widths: 1 for a batch-1 level, one shared Bmax for the rest;
    # padding rows (0, 0, dump) align leaf 0 with itself into the dump slot
    Bmax = _pow2_batch(max(len(ia) for ia, _, _ in levels))
    rows, plan = [], []
    for ia, ib, iout in levels:
        B = len(ia)
        Bp = 1 if B == 1 else Bmax
        pad = Bp - B
        rows.append(np.stack([np.concatenate([ia, np.zeros(pad, np.int64)]),
                              np.concatenate([ib, np.zeros(pad, np.int64)]),
                              np.concatenate([iout, np.full(pad, dump, np.int64)])], axis=1))
        plan.append((B, Bp))
    IDX = torch.from_numpy(np.concatenate(rows)).to(dev)  # the run's one index upload

    t0 = time.perf_counter()
    ops_out, len_out = [], []
    with enqueue_guard(dev):
        off = 0
        for B, Bp in plan:
            ops_rev, n_new = _pool_level(MU, MB, ST, LN, IDX[off:off + Bp], gap_open,
                                         gap_extend, seq_weight, has_base, exact)
            ops_out.append(ops_rev)
            len_out.append(n_new)
            off += Bp
        ops_d, len_d = torch.cat(ops_out), torch.cat(len_out)
    t1 = time.perf_counter()
    # the run's one download
    ops_all, len_all = ops_d.cpu().numpy(), len_d.cpu().numpy()
    t2 = time.perf_counter()
    if stats is not None:
        stats.update(enqueue_s=t1 - t0, device_download_s=t2 - t1, levels=len(levels),
                     steps=len(plan))

    ops_host, lengths = [], []
    off = 0
    for B, Bp in plan:
        ops_host.append(ops_all[off:off + B])
        lengths.append(len_all[off:off + B])
        off += Bp
    if any(int(ln.max(initial=0)) > P for ln in lengths):
        return None  # overflow: a merge outgrew the padded length
    return ops_host, lengths
