"""Device selection for the port's entry points.

The port runs on the GPU.  The CPU is used only when a caller asks for
it by name (the tests do), so a machine without a card never runs the
port on the CPU by accident.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` and ``"cuda"`` give the current CUDA device, and raise
    when there is none; ``"cpu"`` gives the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def disable_tf32() -> None:
    """Keep float32 products in full float32 on the card, as the JAX
    package's default ``matmul_precision="highest"`` does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
