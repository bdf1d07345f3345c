"""Capacity ladder of the length buckets (port of
``ginfinity_tpu/graphs/batching.py::_round_capacity``)."""

from __future__ import annotations

_LADDER = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
           4096, 6144, 8192, 12288, 16384)


def _round_capacity(n: int) -> int:
    """Smallest ladder rung holding ``n``; beyond the ladder, the next
    multiple of 4096."""
    for c in _LADDER:
        if n <= c:
            return c
    return ((n + 4095) // 4096) * 4096
