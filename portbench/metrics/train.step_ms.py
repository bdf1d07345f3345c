"""``train.step_ms``: each call of the train step
(``training/train.py::make_train_step``, root span ``train.step``:
forward, loss, backward, Adam), mean milliseconds a step by the span's
CUDA events."""

from portbench import spans


def read(r):
    ms = spans.root_ms("train.step", device=True)
    return sum(ms) / len(ms) if ms else None
