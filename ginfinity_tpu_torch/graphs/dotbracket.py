"""Dot-bracket parsing: validation, pair tables, loop metadata.

Port of ``ginfinity_tpu/graphs/dotbracket.py``.  The pair table is the
native scan (``utils/native.py``, built at first use), as in the JAX
package; ``_py_pair_table`` is its pure-Python twin, kept as the
reference the tests hold the scan to.

Supported notation: ``.`` unpaired, ``()``, and pseudoknot annotations
``[]``, ``{}``, ``<>`` plus matching upper/lowercase letter pairs
(``A``/``a`` ... ``Z``/``z``).
"""

from __future__ import annotations

import numpy as np

from ginfinity_tpu_torch.utils.native import native_pair_table

_OPENERS = {"(": 0, "[": 1, "{": 2, "<": 3}
_CLOSERS = {")": "(", "]": "[", "}": "{", ">": "<"}


def is_valid_dot_bracket(structure: str) -> bool:
    """Every closer matches the most recent unmatched opener of its own
    bracket family, and every stack is empty at the end."""
    return pair_table(structure, strict=False) is not None


def pair_table(structure: str, strict: bool = True) -> np.ndarray | None:
    """``pt[i] = j`` if (i, j) pair, ``-1`` if ``i`` is unpaired.

    Returns ``None`` for malformed input, or raises if ``strict``.
    """
    pt = native_pair_table(structure)
    if pt is None and strict:
        raise ValueError(f"Invalid dot-bracket string: {structure!r}")
    return pt


def _py_pair_table(structure: str, strict: bool = True) -> np.ndarray | None:
    """The pure-Python scan: :func:`pair_table`'s results."""
    n = len(structure)
    pt = np.full(n, -1, dtype=np.int32)
    stacks: dict[str, list[int]] = {}

    def fail():
        if strict:
            raise ValueError(f"Invalid dot-bracket string: {structure!r}")
        return None

    for i, c in enumerate(structure):
        if c == ".":
            continue
        if c in _OPENERS or "A" <= c <= "Z":
            stacks.setdefault(c, []).append(i)
        elif c in _CLOSERS or "a" <= c <= "z":
            st = stacks.get(_CLOSERS.get(c) or c.upper())
            if not st:
                return fail()
            j = st.pop()
            pt[i] = j
            pt[j] = i
        else:
            return fail()

    if any(stacks.values()):
        return fail()
    return pt


def loop_features(pt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per position, for maximal runs of unpaired positions:
    ``loop_size_norm = run_length / seq_len`` and ``loop_pos_norm =
    pos_in_run / (run_length - 1)`` (0.5 for a run of one).  Paired
    positions get 0.0 for both."""
    n = pt.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)

    unpaired = pt < 0
    if not unpaired.any():
        return np.zeros(n, np.float32), np.zeros(n, np.float32)

    idx = np.arange(n)
    starts = unpaired & ~np.concatenate(([False], unpaired[:-1]))
    run_id = np.cumsum(starts) - 1
    start_idx = np.maximum.accumulate(np.where(starts, idx, 0))
    pos_in_run = idx - start_idx
    run_len = np.bincount(run_id[unpaired])
    rl = run_len[np.maximum(run_id, 0)]

    loop_size_norm = np.where(unpaired, rl / max(1, n), 0.0).astype(np.float32)
    rel = np.where(rl > 1, pos_in_run / np.maximum(rl - 1, 1), 0.5)
    loop_pos_norm = np.where(unpaired, rel, 0.0).astype(np.float32)
    return loop_size_norm, loop_pos_norm


_BASE_LUT = np.zeros((256, 4), dtype=np.float32)
for _c, _k in (("A", 0), ("C", 1), ("G", 2), ("U", 3)):
    _BASE_LUT[ord(_c), _k] = 1.0
    _BASE_LUT[ord(_c.lower()), _k] = 1.0


def one_hot_sequence(sequence: str | None, n: int) -> np.ndarray:
    """ACGU one-hot; unknown characters map to all-zeros."""
    out = np.zeros((n, 4), dtype=np.float32)
    if sequence:
        m = min(len(sequence), n)
        codes = np.frombuffer(sequence[:m].encode("latin-1"), dtype=np.uint8)
        out[:m] = _BASE_LUT[codes]
    return out
