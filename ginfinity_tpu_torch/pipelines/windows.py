"""Window start selection (port of ``window_starts_mask`` in
``ginfinity_tpu/pipelines/windows.py``)."""

from __future__ import annotations

import numpy as np


def window_starts_mask(structure: str, L: int, mask_threshold: float) -> np.ndarray:
    """Low-complexity filter: ``keep[start]`` is True when the window's
    fraction of '(' and ')' characters reaches ``mask_threshold``."""
    n = len(structure)
    n_windows = n - L + 1
    if n_windows <= 0:
        return np.zeros(0, dtype=bool)
    if mask_threshold <= 0:
        return np.ones(n_windows, dtype=bool)
    codes = np.frombuffer(structure.encode("latin-1"), dtype=np.uint8)
    paired = ((codes == ord("(")) | (codes == ord(")"))).astype(np.int32)
    csum = np.concatenate(([0], np.cumsum(paired)))
    counts = csum[L:] - csum[:-L]
    return (counts / L) >= mask_threshold
