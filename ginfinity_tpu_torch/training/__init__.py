from ginfinity_tpu_torch.training.losses import (
    AlignmentLossConfig,
    alignment_contrastive_loss,
    regression_loss,
    triplet_loss,
)
from ginfinity_tpu_torch.training.train import EarlyStopping, TrainState, make_train_step

__all__ = [
    "triplet_loss",
    "regression_loss",
    "alignment_contrastive_loss",
    "AlignmentLossConfig",
    "TrainState",
    "make_train_step",
    "EarlyStopping",
]
