"""``train.adam_ms``: Adam (``optimizer.step()``), from the CUDA events
of span ``train.adam``, milliseconds per train step (span
``train.step``, ``training/train.py::make_train_step``)."""

from portbench import spans


def read(r):
    return spans.per_root("train.step", ("train.adam",), device=True)
