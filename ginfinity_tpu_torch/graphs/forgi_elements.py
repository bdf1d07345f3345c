"""Structural-element decomposition from a pair table.

Port of ``ginfinity_tpu/graphs/forgi_elements.py`` (numpy and the
standard library only), the element classification the reference takes
from the forgi package: stems, hairpin loops, interior loops, multiloop
segments, 5'/3' dangling ends.

- **stem**: maximal run of stacked base pairs (i, j), (i+1, j-1), ...
- **hairpin**: the unpaired run enclosed by a stem with no branches.
- **internal**: both unpaired strands between exactly two stems,
  combined into one element.
- **multiloop**: each single-stranded segment of a loop with >= 2
  branches is its own element (zero-length segments included), and
  exterior-loop segments between top-level stems are multiloop segments
  as in forgi.
- **five_prime** / **three_prime**: leading / trailing unpaired runs.

Pseudoknots: crossing pairs are removed (an inclusion-maximal
non-crossing subset) for classification, and their positions count as
loop members; the base-pair edges themselves come from the full pair
table (:mod:`ginfinity_tpu_torch.graphs.build`).

Element *connections* (meta <-> meta edges) mirror forgi's ``bg.edges``:
every loop element connects to the stem(s) it borders.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Element:
    kind: str  # one of FORGI_NODE_TYPES
    members: list[int]  # base positions belonging to this element
    connected_stems: list[int] = dataclasses.field(default_factory=list)
    # indices into the stems list; used to derive element<->element edges


def _nested_pairs(pt: np.ndarray) -> np.ndarray:
    """Inclusion-maximal non-crossing subset of the pair table.

    Pass 1 is the greedy stack scan (a closer whose opener is no longer
    on top drops the buried opener's pair — later/inner pairs win).
    That greedy can also drop pairs whose every crosser itself ended up
    dropped, leaving a non-maximal set (e.g. '([)(])' kept only (3,5)
    while (0,2) crosses nothing kept) — pass 2 re-adds any dropped pair
    that does not cross the kept set, so no nested stem is ever
    misclassified as loop positions just because a pseudoknot touched
    it."""
    n = pt.shape[0]
    nested = np.full(n, -1, dtype=np.int32)
    stack: list[int] = []
    for i in range(n):
        j = int(pt[i])
        if j < 0:
            continue
        if j > i:
            stack.append(i)
        else:
            if stack and stack[-1] == j:
                stack.pop()
                nested[i] = j
                nested[j] = i
            elif j in stack:  # crossing pair: drop it
                stack.remove(j)
    dropped = [
        (i, int(pt[i]))
        for i in range(n)
        if int(pt[i]) > i and int(nested[i]) != int(pt[i])
    ]
    if dropped:
        kept = [(i, int(nested[i])) for i in range(n) if int(nested[i]) > i]
        for a, b in dropped:  # left-to-right, like the scan
            if not any(
                (c < a < d < b) or (a < c < b < d) for c, d in kept
            ):
                nested[a], nested[b] = b, a
                kept.append((a, b))
    return nested


def _find_stems(nested: np.ndarray) -> tuple[list[tuple[int, int, int]], dict[int, int]]:
    """Maximal stacked-pair runs.

    Returns (stems, open_pos_to_stem) where each stem is
    ``(i0, j0, k)``: pairs (i0, j0), (i0+1, j0-1), ..., (i0+k, j0-k).
    """
    n = nested.shape[0]
    stems: list[tuple[int, int, int]] = []
    pos2stem: dict[int, int] = {}
    i = 0
    while i < n:
        j = int(nested[i])
        if j > i and i not in pos2stem:
            k = 0
            while (
                i + k + 1 < n
                and int(nested[i + k + 1]) == j - k - 1
                and int(nested[i + k + 1]) > i + k + 1
            ):
                k += 1
            sid = len(stems)
            stems.append((i, j, k))
            for d in range(k + 1):
                pos2stem[i + d] = sid
                pos2stem[j - d] = sid
            i = i + k + 1
        else:
            i += 1
    return stems, pos2stem


def _scan_level(nested: np.ndarray, lo: int, hi: int, pos2stem: dict[int, int]):
    """Scan positions lo..hi (inclusive) at one nesting level.

    Yields the alternating sequence run0, stem0, run1, stem1, ..., runK
    as (runs, stem_ids) where runs has len(stem_ids)+1 entries (runs may
    be empty lists).  'Free' positions are those unpaired in the nested
    structure (this includes crossing-pair positions, see module doc).
    """
    runs: list[list[int]] = [[]]
    stem_ids: list[int] = []
    i = lo
    while i <= hi:
        j = int(nested[i])
        if j > i:
            stem_ids.append(pos2stem[i])
            runs.append([])
            i = j + 1
        else:
            runs[-1].append(i)
            i += 1
    return runs, stem_ids


def decompose_elements(pt: np.ndarray) -> list[Element]:
    """Full element decomposition of a structure's pair table."""
    n = pt.shape[0]
    nested = _nested_pairs(pt)
    stems, pos2stem = _find_stems(nested)

    elements: list[Element] = []
    # Stems first (stable ids: element index of stem s is s).
    for sid, (i0, j0, k) in enumerate(stems):
        members = list(range(i0, i0 + k + 1)) + list(range(j0 - k, j0 + 1))
        elements.append(Element("stem", sorted(members), [sid]))

    def add_loop(kind: str, members: list[int], stems_touched: list[int]):
        elements.append(Element(kind, sorted(members), stems_touched))

    # Exterior level.
    runs, level_stems = _scan_level(nested, 0, n - 1, pos2stem)
    if level_stems:
        if runs[0]:
            add_loop("five_prime", runs[0], [level_stems[0]])
        for t in range(1, len(level_stems)):
            # segment between consecutive top-level stems -> multiloop (forgi)
            add_loop("multiloop", runs[t], [level_stems[t - 1], level_stems[t]])
        if runs[-1]:
            add_loop("three_prime", runs[-1], [level_stems[-1]])
    elif runs[0]:
        # no pairs at all: a single 5' element (degenerate)
        add_loop("five_prime", runs[0], [])

    # Interior of every stem.
    for sid, (i0, j0, k) in enumerate(stems):
        lo, hi = i0 + k + 1, j0 - k - 1
        if lo > hi:
            # immediately stacked interior impossible by stem maximality,
            # but (lo, hi) may be an empty hairpin "()"
            add_loop("hairpin", [], [sid])
            continue
        runs, level_stems = _scan_level(nested, lo, hi, pos2stem)
        if not level_stems:
            add_loop("hairpin", runs[0], [sid])
        elif len(level_stems) == 1:
            add_loop("internal", runs[0] + runs[1], [sid, level_stems[0]])
        else:
            add_loop("multiloop", runs[0], [sid, level_stems[0]])
            for t in range(1, len(level_stems)):
                add_loop("multiloop", runs[t], [level_stems[t - 1], level_stems[t]])
            add_loop("multiloop", runs[-1], [level_stems[-1], sid])

    return elements


def element_connections(elements: list[Element]) -> list[tuple[int, int]]:
    """Element<->element adjacency (forgi's ``bg.edges``): every loop
    element connects to the stems it borders."""
    conns = set()
    for idx, el in enumerate(elements):
        if el.kind == "stem":
            continue
        for sid in el.connected_stems:
            a, b = sorted((idx, sid))
            if a != b:
                conns.add((a, b))
    return sorted(conns)
