"""The alignment DP's traceback on the card: the CUDA kernel's wrapper.

Stands for no TPU kernel: the JAX package downloads the DP's codes and
walks them on the host (``ginfinity_tpu/ops/dp.py::_traceback_global``
and ``_traceback_local``).  :func:`dp_traceback` runs the hand-written
kernel ``csrc/dp_traceback.cu`` on CUDA tensors, where the codes were
made, and the plain version :func:`dp_traceback_plain` (the host walk
:func:`ginfinity_tpu_torch.ops.dp.paths_from_codes`) on CPU tensors; it
never falls back from one to the other.  Both give a batch's paths as
arrays, which :func:`paths_from_arrays` turns into the ``(i, j)`` step
lists the callers take.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops.dp import paths_from_codes
from ginfinity_tpu_torch.ops.dp_wavefront import _check_mode


def dp_traceback(codes: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                 bi: torch.Tensor, bj: torch.Tensor, mode: str):
    """The paths of a batch whose sheared codes ``[B, L1 + L2, L1 + 1]``
    uint8 the wavefront gave (K2 or the plain version), from ``(l1, l2)``
    in global mode and from ``(bi, bj)`` in local mode, on ``codes``'
    device: ``(path_i, path_j, n)``, where pair ``b``'s path of ``n[b]``
    steps fills the last ``n[b]`` entries of rows ``b`` of ``path_i``
    and ``path_j`` (int32 ``[B, L1 + L2]``, -1 for a gap) in forward
    order; the entries before them are unspecified.  Each kernel launch
    adds one to ``dp_traceback.launches``."""
    local = _check_mode(mode)
    if not _build.on_card(codes, "dp_traceback"):
        return dp_traceback_plain(codes, l1, l2, bi, bj, mode)
    if codes.dtype != torch.uint8 or codes.dim() != 3 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous uint8 [B, L1+L2, L1+1] tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    B, D, W = codes.shape
    for name, t in (("l1", l1), ("l2", l2), ("bi", bi), ("bj", bj)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B,) or t.device != codes.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{B}] tensor on "
                             f"{codes.device}")
    path_i = torch.empty((B, D), dtype=torch.int32, device=codes.device)
    path_j = torch.empty_like(path_i)
    n = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B == 0:
        return path_i, path_j, n
    _build.call("dp_traceback_launch", codes.device, codes.data_ptr(), l1.data_ptr(),
                l2.data_ptr(), bi.data_ptr(), bj.data_ptr(), B, W - 1, D - W + 1, int(local),
                path_i.data_ptr(), path_j.data_ptr(), n.data_ptr())
    dp_traceback.launches += 1
    return path_i, path_j, n


dp_traceback.launches = 0


def dp_traceback_plain(codes: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                       bi: torch.Tensor, bj: torch.Tensor, mode: str):
    """The kernel's function on the host: :func:`paths_from_codes`, its
    paths laid out as the kernel lays them out (the entries before each
    path -2, an index no path holds)."""
    arrays = [t.cpu().numpy() for t in (codes, l1, l2, bi, bj)]
    paths = paths_from_codes(*arrays, mode)
    B, D = codes.shape[:2]
    path_i = np.full((B, D), -2, np.int32)
    path_j = np.full((B, D), -2, np.int32)
    n = np.array([len(p) for p in paths], np.int32)
    for k, p in enumerate(paths):
        if p:
            steps = np.array([(-1 if a is None else a, -1 if b is None else b) for a, b in p],
                             np.int32)
            path_i[k, D - len(p):], path_j[k, D - len(p):] = steps.T
    return tuple(torch.from_numpy(x).to(codes.device) for x in (path_i, path_j, n))


def paths_from_arrays(path_i: np.ndarray, path_j: np.ndarray, n: np.ndarray) -> list[list]:
    """The ``(i, j)`` step lists (``None`` for a gap, Python ints) of
    paths laid out as :func:`dp_traceback` gives them."""
    D = path_i.shape[1]
    tail = np.arange(D)[None, :] >= (D - np.asarray(n))[:, None]
    index = [*range(D), None]  # index[-1]: a gap
    steps = list(zip(map(index.__getitem__, path_i[tail].tolist()),
                     map(index.__getitem__, path_j[tail].tolist())))  # in pair order
    ends = np.cumsum(n).tolist()
    return [steps[a:b] for a, b in zip([0] + ends[:-1], ends)]
