"""GINE model configuration, parameters and checkpoint I/O."""

from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, encode_nodes, forward_once, init_params
from ginfinity_tpu_torch.models.checkpoint import (
    export_torch_checkpoint,
    import_torch_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "GINConfig",
    "GINModel",
    "init_params",
    "forward_once",
    "encode_nodes",
    "load_checkpoint",
    "save_checkpoint",
    "import_torch_checkpoint",
    "export_torch_checkpoint",
]
