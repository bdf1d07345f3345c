"""Affine-gap alignment DP (Gotoh) as a batched anti-diagonal wavefront.

Port of ``ginfinity_tpu/ops/dp.py``.  Anti-diagonal ``d = i + j`` depends
only on diagonals ``d-1`` and ``d-2``, so many pairs run at once, one
diagonal after the other.  On a CUDA device each batch inside the
kernel's gate (:func:`dp_kernel_ok`) is one launch of the hand-written
kernel ``csrc/dp_wavefront.cu`` (through ``ops/dp_wavefront.py``); a
batch outside the gate runs :func:`wavefront_plain` on the card, one
torch step per diagonal, as the JAX package runs ``lax`` outside its
Pallas kernel's VMEM gate.  On the CPU the plain version runs.

Tie rules, identical in both versions:
  E (gap in B, up):   from-H wins ties over from-E
  F (gap in A, left): from-H wins ties over from-F
  H: diag wins ties over E, E over F; local mode clamps at 0 (code 3)
     and keeps the first maximum (smallest d, then smallest i).
Traceback codes ``TH | TE<<2 | TF<<3`` per cell are walked on the host,
in place on the diagonal planes.

Global boundaries ``go + (k - 1) ge`` are rounded once, as the fused
multiply-add XLA makes of the JAX package's expression (a separate
product and sum differ in the last bit for 2 of the first 40 ``k`` at
``ge = -0.3``); the kernel uses ``__fmaf_rn``, this version float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.utils import trace
from ginfinity_tpu_torch.utils.device import resolve_device

NEG = -1e9  # the reference's minus-infinity sentinel
MODES = ("global", "local")


def _check_mode(mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode == "local"


def wavefront_plain(scores: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                    gap_open: float, gap_extend: float, mode: str):
    """The DP of a batch of padded score matrices, one torch step per
    anti-diagonal over ``[B, L1+1]`` tensors.

    ``scores [B, L1, L2]`` float32; ``l1, l2 [B]`` int32 real lengths.
    Returns ``(best [B] f32, bi [B] i32, bj [B] i32, codes [B, D, L1+1]
    uint8)`` with ``D = L1 + L2`` diagonals (``d = 1..D``).  A run on a
    CUDA device adds one to ``wavefront_plain.launches``."""
    local = _check_mode(mode)
    B, L1, L2 = scores.shape
    D = L1 + L2
    dev = scores.device
    f32 = torch.float32
    iidx = torch.arange(L1 + 1, device=dev)
    l1c = l1.to(dev, torch.int64)[:, None]
    l2c = l2.to(dev, torch.int64)[:, None]
    go = torch.tensor(gap_open, dtype=f32, device=dev)
    ge = torch.tensor(gap_extend, dtype=f32, device=dev)

    def boundary(k):  # go + (k - 1) ge rounded once, as a fused multiply-add
        return (go.double() + (k.double() - 1.0) * ge.double()).to(f32)

    neg_col = torch.full((B, 1), NEG, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    u8 = torch.uint8

    def shift_down(x):  # x[:, i] -> x[:, i-1] at position i
        return torch.cat([neg_col, x[:, :-1]], dim=1)

    H1 = torch.full((B, L1 + 1), NEG, dtype=f32, device=dev)
    H1[:, 0] = 0.0  # diagonal 0: only cell (0, 0)
    H2 = torch.full_like(H1, NEG)
    E1 = torch.full_like(H1, NEG)
    F1 = torch.full_like(H1, NEG)
    best = torch.full((B,), 0.0 if local else NEG, dtype=f32, device=dev)
    bi = torch.zeros(B, dtype=torch.int64, device=dev)
    bj = torch.zeros(B, dtype=torch.int64, device=dev)
    codes = torch.empty((B, D, L1 + 1), dtype=u8, device=dev)
    if dev.type == "cuda":
        wavefront_plain.launches += 1
    si = torch.clamp(iidx - 1, 0, L1 - 1)
    is_i0 = (iidx == 0)[None, :]
    h_col0 = boundary(iidx)  # H[i, 0]
    big = torch.full((B, L1 + 1), 2 ** 30, dtype=torch.int64, device=dev)

    for d in range(1, D + 1):
        j = d - iidx
        valid = (iidx[None, :] <= l1c) & (j[None, :] >= 0) & (j[None, :] <= l2c)
        s = scores[:, si, torch.clamp(j - 1, 0, L2 - 1)]

        e_from_h = shift_down(H1) + go
        e_from_e = shift_down(E1) + ge
        E = torch.maximum(e_from_h, e_from_e)
        TE = (e_from_h < e_from_e).to(u8)  # 0 = from H (ties -> H)

        f_from_h = H1 + go
        f_from_f = F1 + ge
        F = torch.maximum(f_from_h, f_from_f)
        TF = (f_from_h < f_from_f).to(u8)

        diag = shift_down(H2) + s
        take_diag = (diag >= E) & (diag >= F)
        e_ge_f = E >= F
        H = torch.where(take_diag, diag, torch.where(e_ge_f, E, F))
        TH = torch.where(take_diag, 0, torch.where(e_ge_f, 1, 2)).to(u8)
        if local:
            stop = H <= 0.0
            TH = torch.where(stop, 3, TH).to(u8)
            H = torch.where(stop, zero, H)

        is_j0 = (j == 0)[None, :]
        on_bound = is_i0 | is_j0
        if local:
            h_bound = zero
            th_bound = torch.tensor(3, dtype=u8, device=dev)
        else:
            h_row0 = boundary(j)  # H[0, j]
            h_bound = torch.where(is_i0, h_row0[None, :], h_col0[None, :])
            th_bound = torch.where(is_i0, 2, 1).to(u8)
        H = torch.where(on_bound, h_bound, H)
        TH = torch.where(on_bound, th_bound, TH)
        E = torch.where(on_bound, NEG, E)
        F = torch.where(on_bound, NEG, F)

        H = torch.where(valid, H, NEG)
        E = torch.where(valid, E, NEG)
        F = torch.where(valid, F, NEG)

        if local:
            cand = torch.where(valid & ~on_bound, H, NEG)
            cmax = cand.max(dim=1).values
            carg = torch.where(cand == cmax[:, None], iidx[None, :], big).min(dim=1).values
            take = cmax > best
            best = torch.where(take, cmax, best)
            bi = torch.where(take, carg, bi)
            bj = torch.where(take, d - carg, bj)
        else:
            at_end = d == (l1c[:, 0] + l2c[:, 0])
            h_end = torch.gather(H, 1, l1c)[:, 0]
            best = torch.where(at_end, h_end, best)
            bi = torch.where(at_end, l1c[:, 0], bi)
            bj = torch.where(at_end, l2c[:, 0], bj)

        codes[:, d - 1] = TH | (TE << 2) | (TF << 3)
        H2, H1, E1, F1 = H1, H, E, F
    return best, bi.to(torch.int32), bj.to(torch.int32), codes


wavefront_plain.launches = 0  # runs on a CUDA device (outside the kernel's gate)


def _cell_codes(plane: np.ndarray):
    """``code(i, j)`` of one pair's diagonal code plane ``[D, L1+1]``, as
    the wavefront writes it: cell (i, j) sits at ``plane[i + j - 1, i]``;
    cell (0, 0), which has no diagonal, reads 0."""
    flat = memoryview(np.ascontiguousarray(plane, np.uint8)).cast("B")
    w = plane.shape[1]

    def code(i: int, j: int) -> int:
        return flat[(i + j - 1) * w + i] if i or j else 0

    return code


def _traceback_global(plane, l1, l2):
    """Follow TH (``code & 3``) back from ``(l1, l2)``; a gap step stays
    in its gap while TE (``code >> 2 & 1``, up) or TF (``code >> 3 & 1``,
    left) of the cell it leaves says so."""
    code = _cell_codes(plane)
    path = []
    i, j = l1, l2
    state = code(i, j) & 3
    while i > 0 or j > 0:
        if state == 0:
            if i == 0 or j == 0:
                break
            path.append((i - 1, j - 1))
            i -= 1
            j -= 1
            state = code(i, j) & 3
        elif state == 1:
            if i == 0:
                break
            path.append((i - 1, None))
            prev = (code(i, j) >> 2) & 1
            i -= 1
            state = 0 if prev == 0 else 1
        else:
            if j == 0:
                break
            path.append((None, j - 1))
            prev = (code(i, j) >> 3) & 1
            j -= 1
            state = 0 if prev == 0 else 2
    path.reverse()
    return path


def _traceback_local(plane, bi, bj):
    """Follow TH from the best cell until a stop cell (code 3) or an
    edge; a gap step continues through TH at the new cell."""
    code = _cell_codes(plane)
    path = []
    i, j = bi, bj
    while i > 0 and j > 0:
        tb = code(i, j) & 3
        if tb == 3:
            break
        if tb == 0:
            path.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif tb == 1:
            path.append((i - 1, None))
            i -= 1
        else:
            path.append((None, j - 1))
            j -= 1
    path.reverse()
    return path


def paths_from_codes(codes: np.ndarray, l1: np.ndarray, l2: np.ndarray,
                     bi: np.ndarray, bj: np.ndarray, mode: str) -> list[list]:
    """Walk every pair's ``[D, L1+1]`` code plane back to its path."""
    out = []
    for k in range(codes.shape[0]):
        with trace.span("dp.traceback"):
            if mode == "global":
                out.append(_traceback_global(codes[k], int(l1[k]), int(l2[k])))
            else:
                out.append(_traceback_local(codes[k], int(bi[k]), int(bj[k])))
    return out


def dp_kernel_ok(L1: int, L2: int, mode: str, smem_limit: int | None = None) -> bool:
    """Whether a batch padded to ``L1 x L2`` runs on the CUDA kernel: the
    kernel's diagonals of ``L1 + 1`` float32 cells must fit the card's
    opt-in shared memory per block (``smem_limit`` bytes; 232,448 on
    Hopper).  Decided by shape, before any launch."""
    from ginfinity_tpu_torch.ops.dp_wavefront import HOPPER_SMEM_OPTIN, smem_bytes

    if mode not in MODES:
        return False
    limit = HOPPER_SMEM_OPTIN if smem_limit is None else smem_limit
    return smem_bytes(L1) <= limit


def pad_batch(score_mats: list[np.ndarray], L1: int | None = None,
              L2: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score matrices zero-padded into one float32 ``[B, L1, L2]`` array
    (by default the batch's largest sides), with their real sides
    ``l1, l2 [B]`` int32."""
    B = len(score_mats)
    L1 = L1 or max(1, max(m.shape[0] for m in score_mats))
    L2 = L2 or max(1, max(m.shape[1] for m in score_mats))
    scores = np.zeros((B, L1, L2), np.float32)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for k, m in enumerate(score_mats):
        scores[k, : m.shape[0], : m.shape[1]] = m
        l1[k], l2[k] = m.shape
    return scores, l1, l2


def _wavefront_on(scores: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                  gap_open: float, gap_extend: float, mode: str):
    """``(best, bi, bj, codes)`` of a padded batch on its device: the CUDA
    kernel on a card whose shared memory holds it, else the plain
    wavefront."""
    from ginfinity_tpu_torch.ops.dp_wavefront import dp_wavefront, smem_limit

    dev = scores.device
    L1, L2 = scores.shape[1:]
    args = (scores, l1, l2, float(gap_open), float(gap_extend), mode)
    if dev.type == "cuda" and dp_kernel_ok(L1, L2, mode, smem_limit(dev)):
        return dp_wavefront(*args)
    return wavefront_plain(*args)


def affine_align_batch(score_mats: list[np.ndarray], gap_open: float, gap_extend: float,
                       mode: str = "global", device=None, mesh=None) -> list[tuple[float, list]]:
    """Align a batch of similarity matrices; returns ``[(score, path)]``
    with paths of ``(i, j)`` steps (``None`` for a gap).

    The batch is padded to its largest ``L1 x L2``; padding cells are
    masked by each pair's real lengths.  The batch axis shards over
    ``mesh`` (``parallel/mesh.py``; by default ``device`` alone, the card
    unless ``"cpu"`` is asked for): the batch is padded with dummy 1 x 1
    pairs to a multiple of the mesh size, each shard's block of pairs runs
    on its device (the kernel on a card), and the results come back in
    order, the dummies dropped.
    """
    _check_mode(mode)
    mesh = mesh or DataMesh([resolve_device(device)])
    if not score_mats:
        return []
    with trace.span("dp.align_batch") as sp:
        scores, l1, l2 = pad_batch(score_mats)
        B, L1, L2 = scores.shape
        sp.add(pairs=B, cells_real=int(((l1.astype(np.int64) + 1) * (l2 + 1)).sum()),
               cells_padded=B * (L1 + 1) * (L2 + 1))
        pad = mesh.padded(B) - B
        shards = zip(*(mesh.split(torch.from_numpy(x)) for x in (
            np.concatenate([scores, np.zeros((pad, L1, L2), np.float32)]),
            np.concatenate([l1, np.ones(pad, np.int32)]),
            np.concatenate([l2, np.ones(pad, np.int32)]))))
        parts = [_wavefront_on(*shard, gap_open, gap_extend, mode) for shard in shards]
        best, bi, bj, codes = (mesh.gather([p[k] for p in parts], B) for k in range(4))
        best, bi, bj = best.cpu().numpy(), bi.cpu().numpy(), bj.cpu().numpy()
        paths = paths_from_codes(codes.cpu().numpy(), l1, l2, bi, bj, mode)
    return [(float(best[k]), paths[k]) for k in range(B)]


def affine_align(score: np.ndarray, gap_open: float, gap_extend: float,
                 mode: str = "global", device=None) -> tuple[float, list]:
    """One pair (the reference's needleman_wunsch_affine /
    smith_waterman_affine)."""
    return affine_align_batch([score], gap_open, gap_extend, mode, device)[0]
