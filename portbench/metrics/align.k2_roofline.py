"""``align.k2_roofline``: the least time K2 could take for the pairs of
the traced segment (the larger of their bytes over the memory rate and
their operations over the float32 rate, ``counts/k2.py``) over the
device time of K2's kernels in the trace."""

KERNELS = ("dp_warp_kernel", "dp_wavefront_kernel")


def read(r):
    if r.trace is None:
        return None
    t = sum(v for k, v in r.trace["kernel_s"].items() if any(n in k for n in KERNELS))
    nbytes, ops = r.traced_counts.get("k2_bytes"), r.traced_counts.get("k2_ops")
    if not t or not nbytes:
        return None
    least = max(nbytes / r.peaks["hbm_bytes_per_s"], ops / r.peaks["f32_flops_per_s"])
    return 100.0 * least / t
