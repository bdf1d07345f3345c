"""The profile DP's value traceback on the card: the CUDA kernel's wrapper.

Stands for the XLA-lowered ``ginfinity_tpu/ops/pairhmm.py::_value_traceback``
(no Pallas kernel), which the JAX package's device pools run on the
device so that a level's op codes stay there for the next level's merge.
:func:`value_traceback` runs the hand-written kernel
``csrc/value_traceback.cu`` on CUDA tensors and the plain PyTorch version
:func:`value_traceback_plain` on CPU tensors; it never falls back from
one to the other.  Both read the diagonal states of
``ops/pairhmm.py::_profile_states`` directly (cell (i, j) of merge b at
``[i + j, :, b, i + 1]``).
"""

from __future__ import annotations

import torch

from ginfinity_tpu_torch.ops import _build

NEG = -1e30


def value_traceback(ST: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Op codes ``[B, L1 + L2]`` int8 in traceback (reverse) order (0
    match, 1 gap-in-B, 2 gap-in-A, 3 padding) of the merges whose states
    ``ST`` (float32 ``[L1 + L2 + 1, 3, B, L1 + 2]``) ``_profile_states``
    gave, from ``(l1, l2)``, on ``ST``'s device.  Lengths past the states
    (a pool merge that outgrew P, reported as an overflow after the run)
    are clamped into them.  Each kernel launch adds one to
    ``value_traceback.launches``."""
    if not _build.on_card(ST, "value_traceback"):
        return value_traceback_plain(ST, l1, l2)
    if ST.dtype != torch.float32 or ST.dim() != 4 or ST.shape[1] != 3 or not ST.is_contiguous():
        raise ValueError("states must be a contiguous float32 [D+1, 3, B, L1+2] tensor, got "
                         f"{ST.dtype} {tuple(ST.shape)}")
    D1, _, B, W = ST.shape
    if l1.shape != (B,) or l2.shape != (B,) or l1.device != ST.device or l2.device != ST.device:
        raise ValueError(f"l1 and l2 must be [{B}] tensors on {ST.device}")
    ops = torch.empty((B, D1 - 1), dtype=torch.int8, device=ST.device)
    if B == 0:
        return ops
    l1 = l1.to(torch.int32).contiguous()
    l2 = l2.to(torch.int32).contiguous()
    _build.call("value_traceback_launch", ST.device, ST.data_ptr(), l1.data_ptr(),
                l2.data_ptr(), B, W - 2, D1 - 1, ops.data_ptr())
    value_traceback.launches += 1
    return ops


value_traceback.launches = 0


def value_traceback_plain(ST: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: a loop over the ``L1 + L2`` steps,
    each one step of every merge."""
    D1, _, B, _ = ST.shape
    dev = ST.device
    L1 = ST.shape[3] - 2
    i = l1.to(dev, torch.int64).clamp(0, L1)
    j = l2.to(dev, torch.int64).clamp(0, D1 - 1 - L1)
    b = torch.arange(B, device=dev)
    ops = torch.full((B, D1 - 1), 3, dtype=torch.int8, device=dev)
    for t in range(D1 - 1):
        cell = ST[i + j, :, b, i + 1]  # [B, 3 (X, M, Y)]
        cm = torch.where((i > 0) & (j > 0), cell[:, 1], NEG)
        cx = torch.where(i > 0, cell[:, 0], NEG)
        cy = torch.where(j > 0, cell[:, 2], NEG)
        state = torch.where(cx > cm, 1, 0)
        state = torch.where(cy > torch.maximum(cm, cx), 2, state)
        active = (i > 0) | (j > 0)
        ops[:, t] = torch.where(active, state, 3).to(torch.int8)
        i -= (active & (state != 2)).to(torch.int64)
        j -= (active & (state != 1)).to(torch.int64)
    return ops
