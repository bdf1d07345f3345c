"""``train.backward_ms``: the backward (``loss.backward()``, or the
shards' ``autograd.grad``), from the CUDA events of span
``train.backward``, milliseconds per train step (span ``train.step``,
``training/train.py::make_train_step``)."""

from portbench import spans


def read(r):
    return spans.per_root("train.step", ("train.backward",), device=True)
