"""The reference's matmul precision: float32 with TF32 off, or TF32 (the
control, the nearest precision below the configurations' float32)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
