"""ginfinity_tpu_torch — the PyTorch/CUDA port of ``ginfinity_tpu``.

It sits beside the JAX package and mirrors its layout (``graphs/``,
``models/``, ``ops/``, ``pipelines/``, ``utils/``).  It imports
``torch``, ``numpy`` and the standard library only; the JAX package is
the reference the port's tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`ginfinity_tpu_torch.utils.device.resolve_device`).  The
one TPU kernel on the windowed-embedding path, the fused window
encoder, is a hand-written CUDA kernel for Hopper
(``ops/csrc/windows_encoder.cu``) built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.graphs.dotbracket import is_valid_dot_bracket, pair_table
from ginfinity_tpu_torch.graphs.build import GraphArrays, build_graph_arrays
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel

__all__ = [
    "resolve_device",
    "is_valid_dot_bracket",
    "pair_table",
    "GraphArrays",
    "build_graph_arrays",
    "GINConfig",
    "GINModel",
]
