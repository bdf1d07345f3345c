"""The affine-gap DP wavefront kernel: the CUDA kernel's wrapper.

Port of the TPU kernel ``ginfinity_tpu/ops/pallas_dp.py::_kernel``.
:func:`dp_wavefront` runs the hand-written kernel ``csrc/dp_wavefront.cu``
on CUDA tensors and the plain PyTorch version
:func:`ginfinity_tpu_torch.ops.dp.wavefront_plain` on CPU tensors; it
never falls back from one to the other.  The kernel has two routes,
chosen by the padded ``L1`` alone (:func:`route`) before any launch:

* ``warp``, for ``L1 + 1 <= 512`` rows: one warp per pair, each lane
  holding ``R`` rows of every diagonal in registers;
* ``cta``, for longer pairs: one CTA per pair, the diagonals of
  ``L1 + 1`` cells in shared memory, so a padded ``L1`` is bounded by
  the card's opt-in shared memory per block: ``L1 + 1 <= 8288`` on
  Hopper (232,448 bytes), see :func:`ginfinity_tpu_torch.ops.dp.dp_kernel_ok`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

HOPPER_SMEM_OPTIN = 232448  # bytes of shared memory one CTA may opt in to on Hopper
_MAX_WARPS = 32
WARP_MAX_ROWS = 16  # rows a lane of the warp route holds at most: 32 x 16 = 512 rows


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


_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' shared library, built and bound at first use."""
    global _lib
    if _lib is None:
        from ginfinity_tpu_torch.ops._build import build_library

        lib = ctypes.CDLL(str(build_library()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dp_wavefront_launch.argtypes = [p, p, p, i, i, i, f, f, i, p, p, p, p, p]
        lib.dp_wavefront_launch.restype = i
        lib.dp_wavefront_warp_launch.argtypes = [p, p, p, i, i, i, f, f, i, i, p, p, p, p, p]
        lib.dp_wavefront_warp_launch.restype = i
        lib.dp_wavefront_smem_bytes.argtypes = [i]
        lib.dp_wavefront_smem_bytes.restype = ctypes.c_size_t
        lib.dp_wavefront_smem_optin.argtypes = [i]
        lib.dp_wavefront_smem_optin.restype = i
        lib.dp_barrier_probe_launch.argtypes = [i, i, i, p, p]
        lib.dp_barrier_probe_launch.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: " + _library().cuda_error_string(err).decode())


def smem_limit(device: torch.device) -> int:
    """The opt-in shared memory per block of a CUDA ``device``, in bytes."""
    lib = _library()
    v = lib.dp_wavefront_smem_optin(device.index if device.index is not None
                                    else torch.cuda.current_device())
    if v < 0:
        _raise_on(-v, "cudaDeviceGetAttribute")
    if lib.dp_wavefront_smem_bytes(1) != smem_bytes(1):
        raise RuntimeError("dp_wavefront: shared-memory sizes of the library and "
                           "the wrapper disagree")
    return v


def dp_wavefront(scores: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                 gap_open: float, gap_extend: float, mode: str):
    """The DP of a batch of padded score matrices: the CUDA kernel for
    CUDA tensors, on the route :func:`route` picks from ``L1``, the plain
    version for CPU tensors.  Arguments and results as
    :func:`ginfinity_tpu_torch.ops.dp.wavefront_plain`, except that the
    kernel leaves the codes outside each pair's rectangle (rows past
    ``l1``, diagonals past ``l1 + l2``, cells past ``l2``) unspecified:
    the traceback never reads them.  Each kernel launch adds one to
    ``dp_wavefront.launches``, and one on the warp route also to
    ``dp_wavefront.warp_launches``."""
    from ginfinity_tpu_torch.ops.dp import wavefront_plain

    if scores.device.type == "cpu":
        return wavefront_plain(scores, l1, l2, gap_open, gap_extend, mode)
    return launch(route(scores.shape[1]), scores, l1, l2, gap_open, gap_extend, mode)


dp_wavefront.launches = 0
dp_wavefront.warp_launches = 0


def launch(rte: tuple[str, int], scores: torch.Tensor, l1: torch.Tensor,
           l2: torch.Tensor, gap_open: float, gap_extend: float, mode: str):
    """One launch of the kernel on CUDA tensors, on the route ``rte`` (as
    :func:`route` gives it).  :func:`dp_wavefront` is the entry point; a
    measurement calls this to time the CTA route on a batch the warp
    route takes."""
    from ginfinity_tpu_torch.ops.dp import _check_mode, dp_kernel_ok

    if scores.device.type != "cuda":
        raise ValueError(f"dp_wavefront: unsupported device {scores.device}")
    local = _check_mode(mode)
    if scores.dtype != torch.float32 or scores.dim() != 3 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous float32 [B, L1, L2] tensor, got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    B, L1, L2 = scores.shape
    for name, t in (("l1", l1), ("l2", l2)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B,) or t.device != scores.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{B}] tensor on "
                             f"{scores.device}")
    if not dp_kernel_ok(L1, L2, mode, smem_limit(scores.device)):
        raise ValueError(f"a batch padded to {L1} x {L2} is outside the kernel's gate "
                         "(dp_kernel_ok); use wavefront_plain")
    dev = scores.device
    codes = torch.empty((B, L1 + L2, L1 + 1), dtype=torch.uint8, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    bi = torch.empty(B, dtype=torch.int32, device=dev)
    bj = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return best, bi, bj, codes
    lib = _library()
    args = (scores.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, L1, L2,
            float(gap_open), float(gap_extend), int(local))
    outs = (codes.data_ptr(), best.data_ptr(), bi.data_ptr(), bj.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if rte[0] == "warp":
            err = lib.dp_wavefront_warp_launch(*args, rte[1], *outs)
        elif rte[0] == "cta":
            err = lib.dp_wavefront_launch(*args, *outs)
        else:
            raise ValueError(f"dp_wavefront: unknown route {rte!r}")
    _raise_on(err, f"dp_wavefront {rte[0]} launch")
    dp_wavefront.launches += 1
    if rte[0] == "warp":
        dp_wavefront.warp_launches += 1
    return best, bi, bj, codes


def barrier_probe(blocks: int, steps: int, L1: int, device: torch.device) -> torch.Tensor:
    """Launch the dependent-step probe of ``csrc/dp_wavefront.cu``:
    ``blocks`` CTAs shaped like the kernel's at padded length ``L1``,
    each running ``steps`` diagonal steps that only wait on each other.
    A measuring aid, not part of any path."""
    out = torch.empty(blocks, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().dp_barrier_probe_launch(
            blocks, steps, L1, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "dp_barrier_probe launch")
    return out
