"""The affine-gap DP wavefront: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the TPU kernel ``ginfinity_tpu/ops/pallas_dp.py::_kernel`` and of
the ``lax`` wavefront of ``ginfinity_tpu/ops/dp.py``.  Anti-diagonal
``d = i + j`` depends only on diagonals ``d-1`` and ``d-2``, so many
pairs run at once, one diagonal after the other.  :func:`dp_wavefront`
is the one place that picks the version: the hand-written kernel
``csrc/dp_wavefront.cu`` for a CUDA batch inside its gate
(:func:`dp_kernel_ok`), else :func:`wavefront_plain`, one torch step per
diagonal, on the batch's own device (CPU or card), as the JAX package
runs ``lax`` outside its Pallas kernel's VMEM gate.  The kernel has two
routes, chosen by the padded ``L1`` alone (:func:`route`) before any
launch:

* ``warp``, for ``L1 + 1 <= 512`` rows: one warp per pair, each lane
  holding ``R`` rows of every diagonal in registers;
* ``cta``, for longer pairs: one CTA per pair, the diagonals of
  ``L1 + 1`` cells in shared memory, so a padded ``L1`` is bounded by
  the card's opt-in shared memory per block: ``L1 + 1 <= 8288`` on
  Hopper (232,448 bytes).

Tie rules, identical in both versions:
  E (gap in B, up):   from-H wins ties over from-E
  F (gap in A, left): from-H wins ties over from-F
  H: diag wins ties over E, E over F; local mode clamps at 0 (code 3)
     and keeps the first maximum (smallest d, then smallest i).
Codes ``TH | TE<<2 | TF<<3`` per cell, on the sheared diagonal planes
that ``ops/dp.py`` walks.

Global boundaries ``go + (k - 1) ge`` are rounded once, as the fused
multiply-add XLA makes of the JAX package's expression (a separate
product and sum differ in the last bit for 2 of the first 40 ``k`` at
``ge = -0.3``); the kernel uses ``__fmaf_rn``, the plain version float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.ops import _build

_MAX_WARPS = 32
WARP_MAX_ROWS = 16  # rows a lane of the warp route holds at most: 32 x 16 = 512 rows
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


def route(L1: int) -> tuple[str, int]:
    """The route of a batch padded to ``L1`` rows: ``("warp", R)`` with
    ``R`` the smallest even number of rows a lane holds such that the 32
    lanes cover the ``L1 + 1`` rows of a diagonal, or ``("cta", 0)`` when
    more than ``32 x WARP_MAX_ROWS`` rows would be needed."""
    R = -(-(L1 + 1) // 32)
    R += R % 2
    return ("warp", R) if R <= WARP_MAX_ROWS else ("cta", 0)


def rectangle_mask(l1: np.ndarray, l2: np.ndarray, L1: int, L2: int) -> np.ndarray:
    """The code cells of each pair's rectangle, ``[B, L1+L2, L1+1]`` bool
    in the codes' sheared layout (row ``d - 1``, column ``i``, cell
    ``(i, d - i)``): ``i <= l1`` and ``0 <= d - i <= l2``.  The kernel's
    codes are specified there and nowhere else."""
    d = np.arange(1, L1 + L2 + 1)[None, :, None]
    i = np.arange(L1 + 1)[None, None, :]
    j = d - i
    l1 = np.asarray(l1, np.int64)[:, None, None]
    l2 = np.asarray(l2, np.int64)[:, None, None]
    return (i <= l1) & (j >= 0) & (j <= l2)


def smem_bytes(L1: int) -> int:
    """Dynamic shared memory of one pair's CTA at padded length ``L1``:
    seven float32 diagonals of ``L1 + 1`` cells (three H, two E, two F)
    and the reduction scratch (``dp_wavefront_smem_bytes`` in the CUDA
    source computes the same)."""
    return 7 * (L1 + 1) * 4 + 3 * _MAX_WARPS * 4


def dp_kernel_ok(L1: int, L2: int, mode: str, smem_limit: int | None = None) -> bool:
    """Whether a batch padded to ``L1 x L2`` runs on the CUDA kernel: the
    kernel's diagonals of ``L1 + 1`` float32 cells must fit the card's
    opt-in shared memory per block (``smem_limit`` bytes; 232,448 on
    Hopper).  Decided by shape, before any launch."""
    if mode not in MODES:
        return False
    limit = _build.HOPPER_SMEM_OPTIN if smem_limit is None else smem_limit
    return smem_bytes(L1) <= limit


def smem_limit(device: torch.device) -> int:
    """The opt-in shared memory per block of a CUDA ``device``, in bytes."""
    v = _build.library().dp_wavefront_smem_optin(
        device.index if device.index is not None else torch.cuda.current_device())
    if v < 0:
        _build.check(-v, "cudaDeviceGetAttribute")
    return v


def dp_wavefront(scores: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                 gap_open: float, gap_extend: float, mode: str):
    """The DP of a batch of padded score matrices on its device, and the
    one place that picks the version: the CUDA kernel for a CUDA batch
    inside :func:`dp_kernel_ok` (against the card's own shared memory), on
    the route :func:`route` picks from ``L1``; else :func:`wavefront_plain`
    on the batch's device.  Arguments and results as
    :func:`wavefront_plain`, except that the kernel leaves the codes
    outside each pair's rectangle (rows past ``l1``, diagonals past
    ``l1 + l2``, cells past ``l2``) unspecified: the traceback never reads
    them.  Each kernel launch adds one to ``dp_wavefront.launches``, and
    one on the warp route also to ``dp_wavefront.warp_launches``."""
    L1, L2 = scores.shape[1:]
    if _build.on_card(scores, "dp_wavefront") and \
            dp_kernel_ok(L1, L2, mode, smem_limit(scores.device)):
        return launch(route(L1), scores, l1, l2, gap_open, gap_extend, mode)
    return wavefront_plain(scores, l1, l2, gap_open, gap_extend, mode)


dp_wavefront.launches = 0
dp_wavefront.warp_launches = 0


def launch(rte: tuple[str, int], scores: torch.Tensor, l1: torch.Tensor,
           l2: torch.Tensor, gap_open: float, gap_extend: float, mode: str):
    """One launch of the kernel on CUDA tensors, on the route ``rte`` (as
    :func:`route` gives it), whatever :func:`dp_wavefront` would pick: a
    measurement calls this to time the CTA route on a batch the warp
    route takes."""
    if scores.device.type != "cuda":
        raise ValueError(f"dp_wavefront: unsupported device {scores.device}")
    local = _check_mode(mode)
    if rte[0] not in ("warp", "cta"):
        raise ValueError(f"dp_wavefront: unknown route {rte!r}")
    if scores.dtype != torch.float32 or scores.dim() != 3 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous float32 [B, L1, L2] tensor, got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    B, L1, L2 = scores.shape
    for name, t in (("l1", l1), ("l2", l2)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B,) or t.device != scores.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{B}] tensor on "
                             f"{scores.device}")
    dev = scores.device
    codes = torch.empty((B, L1 + L2, L1 + 1), dtype=torch.uint8, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    bi = torch.empty(B, dtype=torch.int32, device=dev)
    bj = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return best, bi, bj, codes
    args = (scores.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, L1, L2,
            float(gap_open), float(gap_extend), int(local))
    outs = (codes.data_ptr(), best.data_ptr(), bi.data_ptr(), bj.data_ptr())
    if rte[0] == "warp":
        _build.call("dp_wavefront_warp_launch", dev, *args, rte[1], *outs)
        dp_wavefront.warp_launches += 1
    else:
        _build.call("dp_wavefront_launch", dev, *args, *outs)
    dp_wavefront.launches += 1
    return best, bi, bj, codes
