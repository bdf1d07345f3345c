"""Kernels of the port, each beside its plain PyTorch version.  The CUDA
library is built at a kernel's first launch, never on import."""

from ginfinity_tpu_torch.ops.dp import affine_align, affine_align_batch

__all__ = ["affine_align", "affine_align_batch"]
