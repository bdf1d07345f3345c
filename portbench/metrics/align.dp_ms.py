"""``align.dp_ms``: the host clock around each call of
``ops/dp.py::affine_align_batch`` (padding, upload, K2, download, host
un-shear and traceback), mean milliseconds a batch."""


def read(r):
    s = r.spans.get("align.dp")
    return 1e3 * sum(s) / len(s) if s else None
