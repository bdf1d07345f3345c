"""Seeded RNA structures and families with known homology.

A copy of the synthetic-family generator that the repository's MSA and
training evaluations use: a random nested ancestor (stems with hairpins
of at least 3 nt and occasional two-way branching, drawn again until at
least 30% of it is paired), a sequence that pairs Watson-Crick on its
stems, and members mutated from it by deletions (a deleted base's
partner becomes unpaired), short unpaired insertions and substitutions,
every kept position tracked back to its ancestor coordinate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.graphs import pair_table

_PAIRED = {"A": "U", "U": "A", "G": "C", "C": "G"}
_BASES = "ACGU"


@dataclasses.dataclass
class Member:
    structure: str
    sequence: str
    posmap: np.ndarray  # ancestor position of each position, -1 for an insertion


def random_structure(rng: np.random.Generator, n: int, p_stem: float = 0.75,
                     min_paired_frac: float = 0.3) -> str:
    def draw() -> str:
        out: list[str] = []

        def gen(m: int, depth: int) -> None:
            if m < 11 or rng.random() > p_stem * (0.9 ** depth):
                out.append("." * m)
                return
            if m >= 26 and rng.random() < 0.35:
                cut = int(rng.integers(11, m - 10))
                gen(cut, depth)
                gen(m - cut, depth)
                return
            h = int(rng.integers(2, min(6, (m - 5) // 2) + 1))
            lead = int(rng.integers(0, min(4, m - 2 * h - 3) + 1))
            tail = int(rng.integers(0, min(4, m - 2 * h - 3 - lead) + 1))
            out.append("." * lead + "(" * h)
            gen(m - 2 * h - lead - tail, depth + 1)
            out.append(")" * h + "." * tail)

        gen(n, 0)
        return "".join(out)

    for _ in range(100):
        s = draw()
        if (s.count("(") + s.count(")")) >= min_paired_frac * n:
            return s
    return s


def random_sequence(rng: np.random.Generator, structure: str) -> str:
    pt = pair_table(structure)
    seq = [""] * len(structure)
    for i, p in enumerate(pt):
        if p < 0:
            seq[i] = _BASES[int(rng.integers(4))]
        elif p > i:
            seq[i] = _BASES[int(rng.integers(4))]
            seq[p] = _PAIRED[seq[i]]
    return "".join(seq)


def mutate(rng: np.random.Generator, structure: str, sequence: str, sub_rate: float,
           del_rate: float, ins_rate: float) -> Member:
    pt = pair_table(structure)
    n = len(structure)
    keep = rng.random(n) >= del_rate
    chars, seq, posmap = [], [], []
    for i in range(n):
        if not keep[i]:
            continue
        chars.append("." if pt[i] >= 0 and not keep[pt[i]] else structure[i])
        s = sequence[i]
        if rng.random() < sub_rate:
            s = _BASES[int(rng.integers(4))]
        seq.append(s)
        posmap.append(i)
        if rng.random() < ins_rate:
            for _ in range(int(rng.integers(1, 4))):
                chars.append(".")
                seq.append(_BASES[int(rng.integers(4))])
                posmap.append(-1)
    return Member("".join(chars), "".join(seq), np.asarray(posmap, np.int64))


def family(seed: int, n_members: int, ancestor_len: int, sub_rate: float = 0.1,
           del_rate: float = 0.05, ins_rate: float = 0.05) -> list[Member]:
    rng = np.random.default_rng(seed)
    anc = random_structure(rng, ancestor_len)
    anc_seq = random_sequence(rng, anc)
    return [mutate(rng, anc, anc_seq, sub_rate, del_rate, ins_rate) for _ in range(n_members)]


def lengths(n: int, lo: int, hi: int, spread: str) -> np.ndarray:
    """``n`` lengths from ``lo`` to ``hi``, evenly (``"linear"``) or
    log-evenly (``"log"``) spaced, dealt in a fixed interleaved order, the
    same for every seed, so each stretch of the list mixes short and long."""
    grid = np.geomspace(lo, hi, n) if spread == "log" else np.linspace(lo, hi, n)
    grid = np.rint(grid).astype(np.int64)
    return grid[np.random.default_rng(0).permutation(n)]


def sub_seed(seed: int, *parts: int) -> int:
    """A seed for one part of a run, from the run's seed."""
    return int(np.random.SeedSequence([seed % 2**63, *parts]).generate_state(1, np.uint64)[0]
               % 2**63)
