"""``train.loss_ms``: the loss (``alignment_loss_fn``: the subset's
gather and the M x M contrastive loss), from the CUDA events of span
``train.loss``, milliseconds per train step (span ``train.step``,
``training/train.py::make_train_step``)."""

from portbench import spans


def read(r):
    return spans.per_root("train.step", ("train.loss",), device=True)
