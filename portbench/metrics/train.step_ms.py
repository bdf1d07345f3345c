"""``train.step_ms``: CUDA events around each call of the train step
(``training/train.py::make_train_step``: forward, loss, backward, Adam)
that the benchmark makes, mean milliseconds a step."""


def read(r):
    ms = r.events_ms.get("train.step")
    return sum(ms) / len(ms) if ms else None
