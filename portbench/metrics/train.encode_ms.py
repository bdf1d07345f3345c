"""``train.encode_ms``: the node embeddings (``alignment_loss_fn``: the
GINE stack in train mode and the node norm), from the CUDA events of
span ``train.encode``, milliseconds per train step (span ``train.step``,
``training/train.py::make_train_step``)."""

from portbench import spans


def read(r):
    return spans.per_root("train.step", ("train.encode",), device=True)
