"""``windows.mfu``: the GINE FLOPs of every window embedded in the
window (``counts/gine.py``, ``counts/k1.py``: node encoder, MLP products,
fc head on real rows), over the window's seconds, as a share of the
card's TF32 tensor-core peak."""


def read(r):
    flops = r.counts.get("gine_flops")
    if not flops:
        return None
    return 100.0 * flops / r.window_s / r.peaks["tf32_flops_per_s"]
