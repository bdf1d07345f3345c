"""``windows.k1_roofline``: the least time K1 could take for the windows
of the traced segment (the larger of its operations over the TF32 peak
and its bytes over the memory rate, ``counts/k1.py``) over the device
time of K1's kernels in the trace."""

KERNELS = ("windows_encoder_kernel",)


def read(r):
    if r.trace is None:
        return None
    t = sum(v for k, v in r.trace["kernel_s"].items() if any(n in k for n in KERNELS))
    ops, nbytes = r.traced_counts.get("k1_flops"), r.traced_counts.get("k1_bytes")
    if not t or not ops:
        return None
    least = max(ops / r.peaks["tf32_flops_per_s"], nbytes / r.peaks["hbm_bytes_per_s"])
    return 100.0 * least / t
