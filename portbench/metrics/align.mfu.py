"""``align.mfu``: the whole alignment step's share of the card's peak:
the least time the card needs for every pair of the window, over the
window's seconds.  A pair's least time is its similarity product at the
TF32 tensor-core rate (``counts/similarity.py``) plus its DP at the
larger of its bytes over the memory rate and its operations over the
float32 rate (``counts/k2.py``), wherever each runs today (the product
on the host, the DP in K2).  It reads the step whichever kernels do the
work, so it still reads when a later change takes K2 off the path and
``align.k2_roofline`` goes silent."""


def read(r):
    nbytes, ops, sim = (r.counts.get(k) for k in ("k2_bytes", "k2_ops", "sim_flops"))
    if not nbytes or not sim:
        return None
    p = r.peaks
    least = sim / p["tf32_flops_per_s"] + max(nbytes / p["hbm_bytes_per_s"],
                                              ops / p["f32_flops_per_s"])
    return 100.0 * least / r.window_s
