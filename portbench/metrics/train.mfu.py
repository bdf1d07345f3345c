"""``train.mfu``: the FLOPs of every training step in the window
(``counts/gine.py::train_step_flops``: forward and backward of the GINE
stack's products and of the loss's M x M cosine product, on real rows),
over the window's seconds, as a share of the card's TF32 tensor-core
peak."""


def read(r):
    flops = r.counts.get("train_flops")
    if not flops:
        return None
    return 100.0 * flops / r.window_s / r.peaks["tf32_flops_per_s"]
