"""``ginfinity-embed-msa`` — embedding-based multiple sequence alignment.

Port of ``ginfinity_tpu/pipelines/msa.py`` (T-Coffee/ProbCons-style):
the same flags (plus ``--device``), stages and output files.

1. load the TSV, L2-normalize per-position embeddings, optional center trim
2. pair selection (all pairs; kNN on mean embeddings past --max-pairs)
3-5. per batch of pairs on the device (``ops/pairhmm.py``): cosine ->
   calibrated log-odds, pair-HMM forward/backward posteriors, row-and-
   column top-k sparsification with pmin, kept as row slabs
6. consistency rounds on the slabs, on the device, then the guide-tree
   distances 1 - mean(kept posteriors)
7. guide tree (NJ / UPGMA), host numpy
8. progressive alignment, one batched profile-DP call per tree level on
   the device: library mode scores columns by the consistency-transformed
   posteriors (the host scorer) and runs the fast DP; profile mode runs
   the reference-exact DP on the column embeddings
9. ``--refine-iters``: split-and-realign refinement (leave-one-out, the
   guide tree's partitions, then seeded random splits), scored on the
   host, each realign one single-merge DP on the device
10. FASTA / Stockholm / TSV outputs and diagnostics

This is the JAX package's host-driven levelized path (its
``GINFINITY_MSA_POOL=0``), which writes the same files as its device
pools and its fused refinement scorer; ``GINFINITY_MSA_POOL`` is
accepted and ignored.  The pools (``ops/profile_pool.py``,
``ops/library_pool.py``) are not ported (ROADMAP queue 1, item 9c);
``--data-parallel`` over several cards is item 11.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.batching import _round_capacity
from ginfinity_tpu_torch.ops.pairhmm import (
    _pair_posteriors_from_embs,
    profile_align_batch_ops,
    profile_align_batch_ops_exact,
)
from ginfinity_tpu_torch.utils.device import disable_tf32, resolve_device
from ginfinity_tpu_torch.utils.io import cell_text, read_table

_F64 = torch.float64


# ==========================================================================
# Records and I/O


@dataclass
class SequenceRecord:
    name: str
    emb: np.ndarray  # (L, D)
    dotbracket: Optional[str] = None
    paired_idx: Optional[list[int]] = None
    base_emb: Optional[np.ndarray] = None


def _json_loads_maybe(x):
    if isinstance(x, (list, dict)):
        return x
    if isinstance(x, str):
        x = x.strip()
        if not x:
            return None
        try:
            return json.loads(x)
        except ValueError:
            return None
    return None


def _parse_matrix_cell(cell) -> Optional[np.ndarray]:
    """JSON matrix cell -> float32 [L, D], or None if malformed."""
    raw = _json_loads_maybe(cell)
    if raw is None:
        return None
    try:
        return np.array(raw, dtype=np.float32)
    except (ValueError, TypeError):
        return None


def _l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    norms = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)
    return (x / norms).astype(np.float32)


def _dotbracket_to_pairs(db: str) -> list[int]:
    L = len(db)
    pairs = [-1] * L
    stacks = {"(": [], "[": [], "{": []}
    mates = {")": "(", "]": "[", "}": "{"}
    for i, ch in enumerate(db):
        if ch in stacks:
            stacks[ch].append(i)
        elif ch in mates and stacks[mates[ch]]:
            j = stacks[mates[ch]].pop()
            pairs[i] = j
            pairs[j] = i
    return pairs


def _pairs_to_dotbracket(pairs: list[int]) -> str:
    return "".join(
        "." if j == -1 else ("(" if j > i else ")") for i, j in enumerate(pairs)
    )


def load_tsv(path, name_col, embeds_col, dotbracket_col=None, paired_col=None,
             base_embeds_col=None) -> list[SequenceRecord]:
    table = read_table(path, sep="\t")
    if name_col not in table.columns or embeds_col not in table.columns:
        raise ValueError(f"Missing required columns: {name_col}, {embeds_col}")
    records = []
    for idx, row in enumerate(table.rows):
        name = cell_text(row[name_col])
        emb = _parse_matrix_cell(row[embeds_col])
        if emb is None:
            print(f"[WARN] Row {idx} ('{name}') has invalid embeddings; skipping.")
            continue
        if emb.ndim != 2 or emb.shape[0] == 0:
            print(f"[WARN] Row {idx} ('{name}') embeddings malformed; skipping.")
            continue
        dotbracket = None
        paired_idx = None
        if paired_col and paired_col in table.columns:
            p = _json_loads_maybe(row[paired_col])
            if isinstance(p, list) and len(p) == emb.shape[0]:
                paired_idx = [int(v) for v in p]
        if paired_idx is None and dotbracket_col and dotbracket_col in table.columns:
            db = row[dotbracket_col]
            if isinstance(db, str) and len(db) == emb.shape[0]:
                dotbracket = db
                paired_idx = _dotbracket_to_pairs(db)
        base_arr = None
        if base_embeds_col and base_embeds_col in table.columns:
            base_arr = _parse_matrix_cell(row[base_embeds_col])
            if base_arr is not None:
                if base_arr.ndim != 2:
                    base_arr = None
                elif base_arr.shape[0] == emb.shape[0] + 2:
                    base_arr = base_arr[1:-1]
                elif base_arr.shape[0] != emb.shape[0]:
                    print(f"[WARN] Row {idx} ('{name}') base embeddings length mismatch; ignoring.")
                    base_arr = None
        records.append(SequenceRecord(name, emb, dotbracket, paired_idx, base_arr))
    return records


def apply_center_trim(records, fraction):
    trims = []
    for rec in records:
        L = rec.emb.shape[0]
        frac = max(0.0, min(1.0, fraction))
        keep = max(1, min(L, int(round(L * frac))))
        start = (L - keep) // 2
        end = min(L, start + keep)
        trims.append((start, end))
        if start <= 0 and end >= L:
            continue
        rec.emb = rec.emb[start:end].copy()
        if rec.base_emb is not None:
            rec.base_emb = rec.base_emb[start:end].copy()
        src = rec.paired_idx or (
            _dotbracket_to_pairs(rec.dotbracket) if rec.dotbracket else None
        )
        if src is not None:
            new_pairs = [
                -1 if (src[i] < start or src[i] >= end or src[i] < 0) else src[i] - start
                for i in range(start, end)
            ]
            rec.paired_idx = new_pairs
            rec.dotbracket = _pairs_to_dotbracket(new_pairs)
        elif rec.dotbracket is not None:
            rec.dotbracket = rec.dotbracket[start:end]
    return trims


# ==========================================================================
# Pair selection, calibration, sparsification


def _profile_dp_exact_enabled() -> bool:
    """Reference-exact float32 profile DP (default on);
    ``GINFINITY_PROFILE_DP=fast`` runs the fast DP on score matrices."""
    return os.environ.get("GINFINITY_PROFILE_DP", "exact") != "fast"


def pairwise_pairs_to_compute(records, max_pairs):
    N = len(records)
    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    if N <= 1:
        return []
    if max_pairs is None or max_pairs <= 0 or len(pairs) <= max_pairs:
        return pairs
    means = np.stack([
        r.emb.mean(axis=0) / (np.linalg.norm(r.emb.mean(axis=0)) + 1e-8) for r in records
    ]).astype(np.float32)
    sims = means @ means.T
    k = max(1, int(max_pairs / max(1, N)))
    nn_pairs = set()
    for i in range(N):
        order = np.argsort(-sims[i])
        c = 0
        for j in order:
            if j == i:
                continue
            nn_pairs.add((min(i, j), max(i, j)))
            c += 1
            if c >= k:
                break
    pairs = sorted(nn_pairs)
    return pairs[:max_pairs] if len(pairs) > max_pairs else pairs


def calibrate_log_odds(S, alpha, beta):
    X = alpha * S + beta
    p = np.clip(1.0 / (1.0 + np.exp(-X)), 1e-6, 1.0 - 1e-6)
    return (np.log(p) - np.log(1.0 - p)).astype(np.float32)


def sparsify_topk_mask(P: np.ndarray, topk: int, pmin: float = 1e-4) -> np.ndarray:
    """Boolean keep-mask: entries in the row top-K AND column top-K with
    P >= pmin (the reference's row/col intersection rule)."""
    La, Lb = P.shape
    row_mask = np.zeros_like(P, dtype=bool)
    k = min(topk, Lb)
    idx = np.argpartition(-P, k - 1, axis=1)[:, :k]
    np.put_along_axis(row_mask, idx, True, axis=1)
    col_mask = np.zeros_like(P, dtype=bool)
    k = min(topk, La)
    idx = np.argpartition(-P, k - 1, axis=0)[:k, :]
    np.put_along_axis(col_mask, idx, True, axis=0)
    return row_mask & col_mask & (P >= pmin)


# ==========================================================================
# Consistency


def consistency_round(post: dict, N: int, lam: float = 0.5, topk: int = 20,
                      pmin: float = 1e-4) -> dict:
    """One T-Coffee consistency round over the sparse-as-dense posterior
    dict, on the host: the oracle of the device rounds below.

    ``post[(a, b)]`` is the dense (sparsified) posterior matrix.
    P'_AB = (1-lam) P_AB + lam * mean_C (P_AC @ P_CB) over intermediates C
    with both (a, C) and (C, b) present; then row/col top-K + pmin."""
    lengths = {}
    for (a, b), P in post.items():
        lengths[a] = P.shape[0]
        lengths[b] = P.shape[1]
    if not lengths:
        return dict(post)

    def get(a, c):
        if (a, c) in post:
            return post[(a, c)]
        if (c, a) in post:
            return post[(c, a)].T
        return None

    out = {}
    for (a, b), Pab in post.items():
        acc = np.zeros_like(Pab)
        count = 0
        for c in range(N):
            if c in (a, b):
                continue
            AC = get(a, c)
            CB = get(c, b)
            if AC is None or CB is None:
                continue
            acc += AC @ CB
            count += 1
        newP = (1.0 - lam) * Pab + lam * (acc / max(1, count))
        keep = sparsify_topk_mask(newP, topk, pmin)
        out[(a, b)] = np.where(keep, newP, 0.0).astype(np.float32)
    return out


_PAIR_BLOCK = 256    # pairs updated per block of a round
_TRIPLE_BLOCK = 256  # (a, C, b) products per batched product


def _densify(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row slabs [T, W, k] -> dense [T, W, W] (zero where nothing is kept)."""
    T, W, _ = vals.shape
    out = torch.zeros((T, W, W), dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(2, idx, vals)


def _consistency_rounds_on_slabs(kv, ki, pairs, N, rounds, lam, pmin, k):
    """Consistency rounds over the row slabs kv/ki [T, W, k] of
    ``pairs`` (forward orientation, (a, b) with a < b).

    Each round densifies every slab once and, per pair (a, b), sums the
    products of the blocks of its present intermediates C, read through a
    signed slot (+t: slab t; -t: its exact transpose).  Products are
    float64 batched products, summed in float64 and rounded once; the
    update and the re-sparsification to the row top-k follow the JAX
    package's float32 order."""
    dev, dt = kv.device, kv.dtype
    T, W, _ = kv.shape
    slot = np.zeros((N, N), np.int64)
    pa = np.asarray([a for a, _ in pairs], np.int64)
    pb = np.asarray([b for _, b in pairs], np.int64)
    slot[pa, pb] = np.arange(1, T + 1)
    slot[pb, pa] = -np.arange(1, T + 1)
    present = slot != 0
    validC = present[pa] & present[:, pb].T  # [T, N]: intermediates per pair
    tt, cc = np.nonzero(validC)
    sA = slot[pa[tt], cc]
    sB = slot[cc, pb[tt]]
    cnt = torch.from_numpy(np.maximum(validC.sum(1), 1)).to(dev, dt)
    lam_t = torch.tensor(float(np.float32(lam)), dtype=dt, device=dev)
    one_minus = torch.tensor(float(np.float32(1.0) - np.float32(lam)), dtype=dt, device=dev)
    pmin_f = float(np.float32(pmin))
    for _ in range(rounds):
        Pd = _densify(kv, ki)
        P64 = Pd.to(_F64)
        new_v = torch.empty_like(kv)
        new_i = torch.empty_like(ki)
        for p0 in range(0, T, _PAIR_BLOCK):
            p1 = min(T, p0 + _PAIR_BLOCK)
            acc = torch.zeros((p1 - p0, W, W), dtype=_F64, device=dev)
            lo, hi = np.searchsorted(tt, [p0, p1])
            for t0 in range(lo, hi, _TRIPLE_BLOCK):
                t1 = min(hi, t0 + _TRIPLE_BLOCK)
                a, b = sA[t0:t1], sB[t0:t1]
                for fa in (True, False):
                    for fb in (True, False):
                        sel = np.nonzero(((a > 0) == fa) & ((b > 0) == fb))[0]
                        if sel.size == 0:
                            continue
                        A = P64[torch.from_numpy(np.abs(a[sel]) - 1).to(dev)]
                        Bm = P64[torch.from_numpy(np.abs(b[sel]) - 1).to(dev)]
                        if not fa:
                            A = A.transpose(1, 2)
                        if not fb:
                            Bm = Bm.transpose(1, 2)
                        rows = torch.from_numpy(tt[t0:t1][sel] - p0).to(dev)
                        acc.index_add_(0, rows, torch.bmm(A, Bm))
            newP = one_minus * Pd[p0:p1] + (lam_t * acc.to(dt)) / cnt[p0:p1, None, None]
            row_kth = torch.topk(newP, k, dim=-1).values[..., -1:]
            col_kth = torch.topk(newP, k, dim=-2).values[..., -1:, :]
            keep = (newP >= row_kth) & (newP >= col_kth) & (newP >= pmin_f)
            new_v[p0:p1], new_i[p0:p1] = torch.topk(torch.where(keep, newP, 0.0), k, dim=-1)
        kv, ki = new_v, new_i
    return kv, ki


def consistency_rounds_to_distances_from_slabs(kv_list, ki_list, pair_chunks, N, k,
                                               rounds, lam: float = 0.5,
                                               pmin: float = 1e-4,
                                               return_slabs: bool = False):
    """Consistency rounds on the posterior stage's per-batch slabs (on the
    device), then the guide-tree distances D [N, N] = 1 - mean of each
    pair's kept posteriors.  ``return_slabs`` also returns the pairs and
    the transformed slabs (the library of library mode)."""
    pairs = [pr for chunk in pair_chunks for pr in chunk]
    if not pairs:
        D0 = np.zeros((N, N), np.float32)
        return (D0, pairs, None, None) if return_slabs else D0
    kv = torch.cat([v[: len(c)] for v, c in zip(kv_list, pair_chunks)])
    ki = torch.cat([i[: len(c)] for i, c in zip(ki_list, pair_chunks)])
    if rounds > 0:
        kv, ki = _consistency_rounds_on_slabs(kv, ki, pairs, N, rounds, lam, pmin, k)
    sums = kv.to(_F64).sum(dim=(-1, -2)).to(kv.dtype).cpu().numpy()
    cnts = (kv > 0).sum(dim=(-1, -2)).to(torch.int32).cpu().numpy()
    D = np.zeros((N, N), np.float32)
    for t, (a, b) in enumerate(pairs):
        d = 1.0 - sums[t] / cnts[t] if cnts[t] > 0 else 1.0
        D[a, b] = D[b, a] = min(1.0, max(0.0, float(d)))
    if return_slabs:
        return D, pairs, kv, ki
    return D


def build_distance_matrix(post: dict, N: int) -> np.ndarray:
    """1 - mean(kept posteriors) as distance."""
    D = np.zeros((N, N), dtype=np.float32)
    for (a, b), P in post.items():
        vals = P[P > 0]
        d = 1.0 if vals.size == 0 else 1.0 - float(vals.mean())
        D[a, b] = D[b, a] = min(1.0, max(0.0, d))
    return D


# ==========================================================================
# Guide tree


def build_guide_tree(D: np.ndarray, method: str = "nj"):
    """NJ / UPGMA guide tree in matrix form; returns the nested-tuple
    topology the progressive aligner consumes.  The working matrix keeps
    clusters in ascending-id order (a new cluster takes the largest id and
    the last row), so the row-major argmin picks the first (a, b) in
    ascending-id order on ties."""
    N = D.shape[0]
    if N == 1:
        return 0
    Wm = D.astype(np.float64).copy()
    np.fill_diagonal(Wm, 0.0)
    nodes: list = list(range(N))
    sizes = np.ones(N, np.float64)
    stop_at = 1 if method == "upgma" else 2
    while len(nodes) > stop_at:
        m = Wm.shape[0]
        if method == "upgma":
            Q = Wm.copy()
        else:
            rsum = Wm.sum(axis=1)
            Q = (m - 2) * Wm - rsum[:, None] - rsum[None, :]
        Q[np.tril_indices(m)] = np.inf
        flat = int(np.argmin(Q))
        a, b = flat // m, flat % m
        dab = Wm[a, b]
        sa, sb = sizes[a], sizes[b]
        if method == "upgma":
            row = (Wm[a] * sa + Wm[b] * sb) / (sa + sb)
        else:
            row = (Wm[a] + Wm[b] - dab) / 2.0
        keep = np.ones(m, bool)
        keep[[a, b]] = False
        Wm = np.pad(Wm[np.ix_(keep, keep)], ((0, 1), (0, 1)))
        Wm[-1, :-1] = Wm[:-1, -1] = row[keep]
        nodes = [n for k, n in enumerate(nodes) if keep[k]] + [(nodes[a], nodes[b])]
        sizes = np.append(sizes[keep], sa + sb)
    return nodes[0] if method == "upgma" else (nodes[0], nodes[1])


# ==========================================================================
# Profiles and progressive alignment


_GAP = np.uint8(ord("-"))


@dataclass
class Profile:
    mu_struct: np.ndarray  # (L, Ds), L2-normalized rows
    mu_base: Optional[np.ndarray]  # (L, Db) or None
    stem: np.ndarray  # (L,)
    member_indices: list[int]
    # per member: uint8 char codes per alignment column ('-' = gap)
    aligned_chars: dict[int, np.ndarray] = field(default_factory=dict)


def initial_profiles(records: list[SequenceRecord]) -> list[Profile]:
    base_dim = next((r.base_emb.shape[1] for r in records if r.base_emb is not None), 0)
    profiles = []
    for idx, r in enumerate(records):
        L = r.emb.shape[0]
        if isinstance(r.dotbracket, str) and len(r.dotbracket) == L:
            chars = np.frombuffer(r.dotbracket.encode("latin-1"), np.uint8).copy()
        elif isinstance(r.paired_idx, list) and len(r.paired_idx) == L:
            chars = np.frombuffer(
                _pairs_to_dotbracket(r.paired_idx).encode("latin-1"), np.uint8
            ).copy()
        else:
            chars = np.full(L, ord("X"), np.uint8)
        stem = np.array(
            [1.0 if (r.paired_idx and r.paired_idx[k] != -1) else 0.0 for k in range(L)],
            np.float32,
        )
        mu_base = None
        if base_dim > 0:
            mu_base = (
                r.base_emb.astype(np.float32)
                if r.base_emb is not None
                else np.zeros((L, base_dim), np.float32)
            )
        profiles.append(Profile(r.emb.astype(np.float32), mu_base, stem, [idx], {idx: chars}))
    return profiles


def _profile_score_matrix(A: Profile, B: Profile, seq_weight: float) -> np.ndarray:
    S = A.mu_struct @ B.mu_struct.T
    if seq_weight > 0.0 and A.mu_base is not None and B.mu_base is not None:
        S = (1.0 - seq_weight) * S + seq_weight * (A.mu_base @ B.mu_base.T)
    comp = np.where(
        (A.stem[:, None] >= 0.5) == (B.stem[None, :] >= 0.5), 0.2, 0.0
    ).astype(np.float32)
    return (S + comp).astype(np.float32)


class PosteriorLibrary:
    """Sparse (consistency-transformed) match posteriors for library-mode
    progressive alignment: columns score by the mean posterior match
    probability between their member positions.  Row-slab layout per
    pair (a, b): ``vals[i, t]`` is the posterior between a's position i
    and b's position ``idx[i, t]`` (zero entries unused).  Device slabs
    are downloaded once, on first use."""

    def __init__(self, pairs, vals, idx, lengths, device_slabs=None):
        self.pairs = list(pairs)
        self.lengths = lengths
        self.device_slabs = device_slabs
        self._vals = vals
        self._idx = idx
        self._by_pair: Optional[dict] = None

    @property
    def by_pair(self) -> dict:
        if self._by_pair is None:
            if self._vals is None:
                self._vals = self.device_slabs[0].cpu().numpy()
                self._idx = self.device_slabs[1].cpu().numpy()
            self._by_pair = {}
            for t, (a, b) in enumerate(self.pairs):
                la = self.lengths[a]
                self._by_pair[(a, b)] = (self._vals[t, :la], self._idx[t, :la])
        return self._by_pair

    def score_matrix(self, A: Profile, B: Profile) -> np.ndarray:
        return self._score_matrix_host(A, B)

    def _score_matrix_host(self, A: Profile, B: Profile) -> np.ndarray:
        La = A.mu_struct.shape[0]
        Lb = B.mu_struct.shape[0]
        flat = np.zeros(La * Lb, np.float64)
        pos_a = {x: _member_pos_to_col(A.aligned_chars[x]) for x in A.member_indices}
        pos_b = {y: _member_pos_to_col(B.aligned_chars[y]) for y in B.member_indices}
        for x in A.member_indices:
            for y in B.member_indices:
                # slab entry (p, t): posterior v[p, t] between the slab
                # owner's position p and the partner's position i[p, t]
                if pos_a[x].size == 0 or pos_b[y].size == 0:
                    continue
                fwd = self.by_pair.get((x, y))
                if fwd is not None:
                    v, i = fwd  # owner = x
                    rows = np.repeat(pos_a[x], v.shape[1])
                    # zero-value padding entries may hold any index: clip,
                    # then mask them out below
                    cols = pos_b[y][np.minimum(i.ravel(), pos_b[y].size - 1)]
                else:
                    rev = self.by_pair.get((y, x))
                    if rev is None:
                        continue  # pair outside the (kNN-capped) library
                    v, i = rev  # owner = y
                    rows = pos_a[x][np.minimum(i.ravel(), pos_a[x].size - 1)]
                    cols = np.repeat(pos_b[y], v.shape[1])
                vv = v.ravel()
                nz = vv > 0
                flat += np.bincount(
                    rows[nz] * Lb + cols[nz], weights=vv[nz], minlength=La * Lb
                )
        denom = len(A.member_indices) * len(B.member_indices)
        return (flat / denom).reshape(La, Lb).astype(np.float32)


def _member_pos_to_col(chars: np.ndarray) -> np.ndarray:
    """For one member's aligned char row: original position -> profile
    column index."""
    return np.nonzero(chars != _GAP)[0]


def merge_profiles(A: Profile, B: Profile, gap_open, gap_extend, seq_weight=0.0,
                   device=None) -> Profile:
    if _profile_dp_exact_enabled():
        ops = profile_align_batch_ops_exact(
            [(A.mu_struct, B.mu_struct)], [(A.stem, B.stem)], gap_open, gap_extend,
            base_pairs=[(A.mu_base, B.mu_base)], seq_weight=seq_weight, device=device,
        )[0]
    else:
        ops = profile_align_batch_ops(
            [_profile_score_matrix(A, B, seq_weight)], gap_open, gap_extend, device=device
        )[0]
    return _merge_from_ops(A, B, ops)


def _merge_from_dp(A: Profile, B: Profile, M, X, Y) -> Profile:
    """Host value-based traceback over dense M/X/Y, then the merge."""
    La, Lb = A.mu_struct.shape[0], B.mu_struct.shape[0]
    i, j = La, Lb
    ops = []  # 0 match, 1 gap-in-B, 2 gap-in-A
    while i > 0 or j > 0:
        cur_state, cur_val = 0, -1e30
        if i > 0 and j > 0 and M[i, j] > cur_val:
            cur_val, cur_state = M[i, j], 0
        if i > 0 and X[i, j] > cur_val:
            cur_val, cur_state = X[i, j], 1
        if j > 0 and Y[i, j] > cur_val:
            cur_val, cur_state = Y[i, j], 2
        ops.append(cur_state)
        if cur_state == 0:
            i -= 1
            j -= 1
        elif cur_state == 1:
            i -= 1
        else:
            j -= 1
    ops.reverse()
    return _merge_from_ops(A, B, ops)


def _merge_from_ops(A: Profile, B: Profile, ops) -> Profile:
    op = np.asarray(ops, np.int8)  # 0 match, 1 gap-in-B, 2 gap-in-A
    base_dim = 0
    if A.mu_base is not None:
        base_dim = A.mu_base.shape[1]
    elif B.mu_base is not None:
        base_dim = B.mu_base.shape[1]
    takes_a = op != 2
    takes_b = op != 1
    match = op == 0
    ia_c = np.where(takes_a, np.cumsum(takes_a) - 1, 0)
    jb_c = np.where(takes_b, np.cumsum(takes_b) - 1, 0)
    ta = takes_a[:, None].astype(np.float32)
    tb = takes_b[:, None].astype(np.float32)

    summed = A.mu_struct[ia_c] * ta + B.mu_struct[jb_c] * tb
    normed = summed / (np.linalg.norm(summed, axis=1, keepdims=True) + 1e-8)
    mu_s = np.where(match[:, None], normed, summed).astype(np.float32)
    mu_b = None
    if base_dim:
        sb = np.zeros((op.size, base_dim), np.float32)
        if A.mu_base is not None:
            sb += A.mu_base[ia_c] * ta
        if B.mu_base is not None:
            sb += B.mu_base[jb_c] * tb
        nb = sb / (np.linalg.norm(sb, axis=1, keepdims=True) + 1e-8)
        mu_b = np.where(match[:, None], nb, sb).astype(np.float32)
    stem = (
        (A.stem[ia_c] * takes_a + B.stem[jb_c] * takes_b)
        / np.maximum(takes_a.astype(np.float32) + takes_b, 1.0)
    ).astype(np.float32)

    members = A.member_indices + B.member_indices
    aligned = {}
    for idx in A.member_indices:
        aligned[idx] = np.where(takes_a, A.aligned_chars[idx][ia_c], _GAP)
    for idx in B.member_indices:
        aligned[idx] = np.where(takes_b, B.aligned_chars[idx][jb_c], _GAP)
    return Profile(mu_s, mu_b, stem, members, aligned)


def _build_levels(internals):
    """Readiness-levelize the internal nodes: list of lists of nodes."""
    levels = []
    resolved_ids: set[int] = set()

    def ready(n):
        def ok(c):
            return isinstance(c, int) or id(c) in resolved_ids
        return ok(n[0]) and ok(n[1])

    remaining = internals
    while remaining:
        lv = [n for n in remaining if ready(n)]
        remaining = [n for n in remaining if not ready(n)]
        for n in lv:
            resolved_ids.add(id(n))
        levels.append(lv)
    return levels


def msa_from_tree(tree, seq_profiles, gap_open, gap_extend, seq_weight=0.0,
                  scorer=None, device=None, split: Optional[dict] = None) -> Profile:
    """Progressive alignment, levelized: each round batches every merge
    whose children are ready into one profile-DP call on ``device``.

    ``scorer`` (library mode) gives each merge's score matrix, aligned by
    the fast DP; without it, profile mode runs the reference-exact DP on
    the column embeddings (the fast DP on ``_profile_score_matrix`` under
    ``GINFINITY_PROFILE_DP=fast``).  ``split``, when given, receives the
    host clock's seconds of scoring, DP and merging, and the rounds'
    (batch, longest A, longest B)."""
    if isinstance(tree, int):
        return seq_profiles[tree]

    internals: list[tuple] = []

    def walk(node):
        if isinstance(node, int):
            return
        walk(node[0])
        walk(node[1])
        internals.append(node)

    walk(tree)
    resolved: dict[int, Profile] = {}

    def get(node):
        if isinstance(node, int):
            return seq_profiles[node]
        return resolved.get(id(node))

    t_score = t_dp = t_merge = 0.0
    rounds = []
    exact = _profile_dp_exact_enabled()
    for ready in _build_levels(internals):
        pairs = [(get(n[0]), get(n[1])) for n in ready]
        t0 = time.perf_counter()
        if scorer is not None:
            mats = [scorer(a, b) for a, b in pairs]
            t1 = time.perf_counter()
            all_ops = profile_align_batch_ops(mats, gap_open, gap_extend, device=device)
        elif exact:
            t1 = time.perf_counter()
            all_ops = profile_align_batch_ops_exact(
                [(a.mu_struct, b.mu_struct) for a, b in pairs],
                [(a.stem, b.stem) for a, b in pairs],
                gap_open, gap_extend,
                base_pairs=[(a.mu_base, b.mu_base) for a, b in pairs],
                seq_weight=seq_weight, device=device,
            )
        else:
            mats = [_profile_score_matrix(a, b, seq_weight) for a, b in pairs]
            t1 = time.perf_counter()
            all_ops = profile_align_batch_ops(mats, gap_open, gap_extend, device=device)
        t2 = time.perf_counter()
        for n, (a, b), ops in zip(ready, pairs, all_ops):
            resolved[id(n)] = _merge_from_ops(a, b, ops)
        t3 = time.perf_counter()
        t_score += t1 - t0
        t_dp += t2 - t1
        t_merge += t3 - t2
        rounds.append((len(ready), max(a.mu_struct.shape[0] for a, _ in pairs),
                       max(b.mu_struct.shape[0] for _, b in pairs)))
    if split is not None:
        split.update(score_s=t_score, dp_s=t_dp, merge_s=t_merge, rounds=rounds)
    return resolved[id(tree)]


# ==========================================================================
# Iterative refinement: split and realign
#
# Each iteration splits the members in two, extracts both sub-alignments
# (all-gap columns dropped), realigns them with the profile DP and keeps
# the result when the sum-of-pairs score improves.  The scores and the
# sub-alignments are host numpy in the JAX package's exact op order: an
# acceptance is decided on a float difference, and one flipped ulp would
# change every later iteration.


def _column_positions(profile: Profile) -> tuple[np.ndarray, np.ndarray]:
    """Per (member, column): the member's residue index, -1 at gaps.
    Returns (members array, pos [n_members, n_cols])."""
    members = np.asarray(profile.member_indices)
    n_cols = len(profile.stem)
    pos = np.full((members.size, n_cols), -1, np.int64)
    for r, idx in enumerate(profile.member_indices):
        chars = np.asarray(profile.aligned_chars[idx])[:n_cols]
        present = chars != _GAP
        pos[r, : chars.size][present] = np.cumsum(present)[present] - 1
    return members, pos


def sp_score(profile: Profile, seq_profiles: list[Profile],
             beta_struct: float = 0.2) -> float:
    """Sum-of-pairs score over the original per-sequence embeddings: for
    every column and every pair of members both present, dot(e_i, e_j)
    plus ``beta_struct`` when their stem flags agree (the profile DP's
    scoring).  Computed with the sum-of-squares identity, no pair loop."""
    members, pos = _column_positions(profile)
    if members.size < 2 or pos.shape[1] == 0:
        return 0.0
    d = seq_profiles[int(members[0])].mu_struct.shape[1]
    present = pos >= 0
    E = np.zeros((members.size, pos.shape[1], d), np.float32)
    stem = np.zeros_like(pos, np.float32)
    for r, idx in enumerate(members):
        sp = seq_profiles[int(idx)]
        p = pos[r][present[r]]
        E[r, present[r]] = sp.mu_struct[p]
        stem[r][present[r]] = sp.stem[p]
    # sum over pairs of dots = (||sum||^2 - sum ||.||^2) / 2, per column
    s = E.sum(axis=0)  # [C, d]
    dot_total = 0.5 * float((s * s).sum() - (E * E).sum())
    n_stem = ((stem >= 0.5) & present).sum(axis=0).astype(np.float64)
    n_un = ((stem < 0.5) & present).sum(axis=0).astype(np.float64)
    agree_pairs = (n_stem * (n_stem - 1) + n_un * (n_un - 1)) / 2.0
    return dot_total + beta_struct * float(agree_pairs.sum())


def extract_subprofile(profile: Profile, members: list[int],
                       seq_profiles: list[Profile]) -> Profile:
    """Sub-alignment restricted to ``members``: columns where every member
    is gapped dropped, column means and stems rebuilt from the original
    per-sequence embeddings."""
    all_members, pos = _column_positions(profile)
    rows = [list(all_members).index(m) for m in members]
    sub = pos[rows]
    keep = (sub >= 0).any(axis=0)
    sub = sub[:, keep]
    n_cols = sub.shape[1]
    d = seq_profiles[int(members[0])].mu_struct.shape[1]
    base_dim = next(
        (seq_profiles[m].mu_base.shape[1] for m in members
         if seq_profiles[m].mu_base is not None), 0
    )
    mu_s = np.zeros((n_cols, d), np.float32)
    mu_b = np.zeros((n_cols, base_dim), np.float32) if base_dim else None
    stem_acc = np.zeros(n_cols, np.float32)
    cnt = np.zeros(n_cols, np.float32)
    aligned = {}
    for r, m in enumerate(members):
        spf = seq_profiles[int(m)]
        pres = sub[r] >= 0
        p = sub[r][pres]
        mu_s[pres] += spf.mu_struct[p]
        if base_dim and spf.mu_base is not None:
            mu_b[pres] += spf.mu_base[p]
        stem_acc[pres] += spf.stem[p]
        cnt[pres] += 1.0
        src = np.asarray(profile.aligned_chars[m])
        if src.size < keep.size:
            src = np.concatenate([src, np.full(keep.size - src.size, _GAP, np.uint8)])
        aligned[m] = src[: keep.size][keep]
    mu_s = mu_s / np.maximum(np.linalg.norm(mu_s, axis=1, keepdims=True), 1e-8)
    if mu_b is not None:
        mu_b = mu_b / np.maximum(np.linalg.norm(mu_b, axis=1, keepdims=True), 1e-8)
    stem = stem_acc / np.maximum(cnt, 1.0)
    return Profile(mu_s, mu_b, stem, list(members), aligned)


def tree_partitions(tree, n: int) -> list[frozenset]:
    """Member sets of the guide tree's internal edges (sizes 2..n-2),
    deduplicated with their complements: the MUSCLE stage-3 restricted
    partitions (singletons are the refinement's leave-one-out sweep).
    Shallow subtrees, nearest the root merge, come first."""
    sets: list[frozenset] = []

    def walk(node) -> frozenset:
        if isinstance(node, int):
            return frozenset((node,))
        s = walk(node[0]) | walk(node[1])
        if 2 <= len(s) <= n - 2:
            sets.append(s)
        return s

    walk(tree)
    seen: set[frozenset] = set()
    out: list[frozenset] = []
    for s in reversed(sets):  # reversed post-order: root-adjacent first
        comp = frozenset(range(n)) - s
        key = min(s, comp, key=lambda x: tuple(sorted(x)))
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    return out


def iterative_refinement(
    aln: Profile,
    seq_profiles: list[Profile],
    iters: int,
    rng: np.random.Generator,
    gap_open: float,
    gap_extend: float,
    seq_weight: float = 0.0,
    scorer=None,
    partitions: list[frozenset] | None = None,
    min_gain: float = 0.0,
    device=None,
    split: Optional[dict] = None,
) -> tuple[Profile, dict]:
    """Split-and-realign refinement; returns (best alignment, stats).

    Schedule: a leave-one-out sweep over every member, then the given
    ``partitions`` (:func:`tree_partitions`), then random binary splits
    (``rng.integers`` for the size, then ``rng.choice``).  Each realign is
    one single-merge DP on ``device``: the fast DP on ``scorer(A, B)``
    (library mode), else :func:`merge_profiles`.  The JAX package's fused
    device scorer and DP (``merge_ops_fn``) writes the same alignments and
    has no counterpart here.

    ``min_gain``: a realign is kept only when it improves the score by
    more than ``min_gain * max(1, |current score|)``; 0 keeps any
    improvement.  ``split``, when given, receives the host clock's
    seconds of extraction, scoring, DP, merging and ``sp_score``."""
    t = dict(extract_s=0.0, score_s=0.0, dp_s=0.0, merge_s=0.0, sp_score_s=0.0)
    t0 = time.perf_counter()
    best = aln
    best_score = sp_score(best, seq_profiles)
    t["sp_score_s"] += time.perf_counter() - t0
    stats = {"sp_initial": best_score, "accepted": 0, "iters": max(0, int(iters))}
    members = list(aln.member_indices)
    if iters <= 0 or len(members) < 3:
        stats["sp_final"] = best_score
        if split is not None:
            split.update(t)
        return best, stats
    parts = partitions or []
    for it in range(int(iters)):
        if it < len(members):
            side = {members[it]}
        elif it - len(members) < len(parts):
            side = set(parts[it - len(members)])
        else:
            k = int(rng.integers(1, len(members)))
            side = set(rng.choice(np.asarray(members), size=k, replace=False).tolist())
        part_a = [m for m in best.member_indices if m in side]
        part_b = [m for m in best.member_indices if m not in side]
        if not part_a or not part_b:
            continue
        t0 = time.perf_counter()
        A = extract_subprofile(best, part_a, seq_profiles)
        B = extract_subprofile(best, part_b, seq_profiles)
        t1 = time.perf_counter()
        if scorer is not None:
            S = scorer(A, B)
            t2 = time.perf_counter()
            ops = profile_align_batch_ops([S], gap_open, gap_extend, device=device)[0]
            t3 = time.perf_counter()
            cand = _merge_from_ops(A, B, ops)
        else:
            t2 = time.perf_counter()
            cand = merge_profiles(A, B, gap_open, gap_extend, seq_weight, device=device)
            t3 = time.perf_counter()
        t4 = time.perf_counter()
        sc = sp_score(cand, seq_profiles)
        t5 = time.perf_counter()
        t["extract_s"] += t1 - t0
        t["score_s"] += t2 - t1
        t["dp_s"] += t3 - t2
        t["merge_s"] += t4 - t3
        t["sp_score_s"] += t5 - t4
        if sc - best_score > min_gain * max(1.0, abs(best_score)):
            best, best_score = cand, sc
            stats["accepted"] += 1
    stats["sp_final"] = best_score
    if split is not None:
        split.update(t)
    return best, stats


# ==========================================================================
# Outputs


def profile_to_msa_strings(profile: Profile, names: list[str]) -> dict[str, str]:
    aln_len = len(profile.stem)
    out = {}
    for idx in profile.member_indices:
        chars = np.asarray(profile.aligned_chars[idx])
        if chars.size < aln_len:
            chars = np.concatenate(
                [chars, np.full(aln_len - chars.size, _GAP, np.uint8)]
            )
        out[names[idx]] = chars[:aln_len].tobytes().decode("latin-1")
    return out


def _tsv_writer(f):
    # DataFrame.to_csv's dialect: tab, minimal quoting, "\n" line ends
    return csv.writer(f, delimiter="\t", lineterminator="\n")


def write_outputs(aln: Profile, names, out_prefix, diagnostics):
    out_dir = os.path.dirname(out_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    msa = profile_to_msa_strings(aln, names)
    with open(f"{out_prefix}.fasta", "w") as f:
        for n in names:
            if n in msa:
                f.write(f">{n}\n{msa[n]}\n")
    with open(f"{out_prefix}.sto", "w") as f:
        f.write("# STOCKHOLM 1.0\n")
        for n in names:
            if n in msa:
                f.write(f"{n} {msa[n]}\n")
        f.write("//\n")
    with open(f"{out_prefix}.aln.tsv", "w", newline="") as f:
        w = _tsv_writer(f)
        w.writerow(["Name", "Aligned"])
        w.writerows(msa.items())
    diag_dir = f"{out_prefix}.diagnostics"
    os.makedirs(diag_dir, exist_ok=True)
    if "expected_scores" in diagnostics:
        # float64 cells written as pandas writes them: repr
        with open(os.path.join(diag_dir, "expected_scores.tsv"), "w", newline="") as f:
            _tsv_writer(f).writerows(
                [repr(float(v)) for v in row] for row in diagnostics["expected_scores"])
    heatmaps = diagnostics.get("posteriors_heatmaps") or []
    if heatmaps:
        try:
            import matplotlib

            matplotlib.use("Agg", force=True)
            import matplotlib.pyplot as plt
        except ImportError:
            plt = None
        if plt is not None:
            for k, (pair, mat) in enumerate(heatmaps):
                if k >= 6:
                    break
                plt.figure(figsize=(4, 4))
                plt.imshow(mat, origin="lower", aspect="auto", cmap="viridis")
                plt.colorbar()
                plt.title(f"Pair {pair[0]}-{pair[1]}")
                plt.tight_layout()
                plt.savefig(os.path.join(diag_dir, f"pair_{pair[0]}_{pair[1]}.png"))
                plt.close()
    meta = {k: v for k, v in diagnostics.items() if k != "posteriors_heatmaps"}
    with open(os.path.join(diag_dir, "run_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


# ==========================================================================
# Main


def build_parser():
    ap = argparse.ArgumentParser(
        description="MSA for RNAs using node embeddings (T-Coffee/ProbCons-style, PyTorch port)"
    )
    ap.add_argument("--input", required=True, help='Input TSV path or "dummy"')
    ap.add_argument("--name-col", default="Name")
    ap.add_argument("--embeds-col", default="node_embeddings")
    ap.add_argument("--base-embeds-col", default=None)
    ap.add_argument("--dotbracket-col", default=None)
    ap.add_argument("--paired-col", default=None)
    ap.add_argument("--out-prefix", default=None)
    ap.add_argument("--topk", type=int, default=20)
    ap.add_argument("--consistency-rounds", type=int, default=1)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Cosine->log-odds calibration slope. Default is "
                         "mode-dependent: 5.0 in profile mode and 8.0 in "
                         "library mode.")
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--seq-weight", type=float, default=0.0)
    ap.add_argument("--gap-open", type=float, default=None,
                    help="Pair-HMM gap-open log-odds. Default is "
                         "mode-dependent: -10.0 in profile mode and -4.0 "
                         "in library mode.")
    ap.add_argument("--gap-extend", type=float, default=-0.5)
    ap.add_argument("--use-center", type=float, default=None)
    ap.add_argument("--use-local", action="store_true",
                    help="Local pair-HMM posteriors (restart/end-anywhere model).")
    ap.add_argument("--tree", choices=["nj", "upgma"], default="nj")
    ap.add_argument("--dp-score", choices=["profile", "library"], default="library",
                    help="Progressive-DP scoring. 'library' (default): columns "
                         "score by the consistency-transformed match "
                         "posteriors. 'profile': raw mean-embedding dots + "
                         "stem bonus, with the reference's alpha/gap defaults.")
    ap.add_argument("--dp-gap-open", type=float, default=None,
                    help="Progressive-DP gap open (library mode defaults "
                         "to 0: posterior scores already price gaps).")
    ap.add_argument("--dp-gap-extend", type=float, default=None)
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="Split-and-realign refinement iterations after the "
                         "progressive alignment (0: none).")
    ap.add_argument("--refine-min-gain", type=float, default=0.002)
    ap.add_argument("--num-workers", type=int, default=4, help="Reference CLI compatibility.")
    ap.add_argument("--max-pairs", type=int, default=2000)
    ap.add_argument("--pair-batch", type=int, default=64,
                    help="Pairs per posterior batch on the device.")
    ap.add_argument("--data-parallel", action="store_true",
                    help="Accepted; one card runs unsharded (several cards: not ported).")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--plot-diagnostics", action="store_true")
    ap.add_argument("--device", default=None,
                    help="Device of the posterior, consistency and DP stages: the "
                         "CUDA device when not given, 'cpu' only when asked.")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.topk < 1:
        raise SystemExit("--topk must be >= 1")
    device = resolve_device(args.device)
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--data-parallel over several cards is not ported yet (ROADMAP queue 1, item 11)"
        )
    disable_tf32()
    random.seed(args.seed)
    np.random.seed(args.seed)
    t_start = time.time()

    out_prefix = args.out_prefix
    if not (out_prefix and str(out_prefix).strip()):
        out_prefix = os.path.join(
            f"embed_msa_out_{time.strftime('%y%m%d_%H%M%S')}", "msa"
        )

    trim_bounds = None
    if args.input == "dummy":
        records = [
            SequenceRecord(
                name=f"seq{i + 1}",
                emb=np.random.randn(random.randint(6, 10), 16).astype(np.float32),
            )
            for i in range(5)
        ]
    else:
        if not (0.0 <= float(args.seq_weight) <= 1.0):
            raise SystemExit("--seq-weight must be in [0,1]")
        records = load_tsv(args.input, args.name_col, args.embeds_col,
                           args.dotbracket_col, args.paired_col, args.base_embeds_col)
        if not records:
            raise SystemExit("No valid records found.")

    if args.use_center is not None:
        frac = float(args.use_center)
        if not (0.0 < frac <= 1.0):
            raise SystemExit("--use-center must be in (0,1].")
        trim_bounds = apply_center_trim(records, frac)

    for r in records:
        r.emb = _l2_normalize_rows(r.emb)
        if r.base_emb is not None:
            r.base_emb = _l2_normalize_rows(r.base_emb)

    N = len(records)
    names = [r.name for r in records]
    dims = {r.emb.shape[1] for r in records}
    if len(dims) != 1:
        raise SystemExit("All embeddings must have the same dimension.")
    pairs = pairwise_pairs_to_compute(records, args.max_pairs)

    want_library_defaults = args.dp_score == "library"
    alpha_default = 8.0 if want_library_defaults else 5.0
    gap_open_default = -4.0 if want_library_defaults else -10.0
    if args.gap_open is None:
        args.gap_open = gap_open_default
    alpha = args.alpha if args.alpha is not None else alpha_default
    beta = args.beta if args.beta is not None else 0.0
    if args.alpha is None or args.beta is None:
        print(f"[WARN] alpha/beta not fully provided; falling back to "
              f"default alpha={alpha}, beta={beta}")

    stage_times: dict[str, float] = {}

    def stage_done(name, t0):
        stage_times[name] = round(time.time() - t0, 2)
        print(f"[{name}] {stage_times[name]}s")
        return time.time()

    if args.data_parallel:
        print("[embed_msa] --data-parallel: single device visible; running unsharded")

    t_stage = time.time()
    print(f"Computing pairwise posteriors for {len(pairs)} pairs...")

    post: dict[tuple[int, int], np.ndarray] = {}
    slab_kv: list = []   # device [bs, W, k] row-top-k posterior slabs
    slab_ki: list = []
    pair_chunks: list[list[tuple[int, int]]] = []
    expected_scores = np.zeros((N, N), np.float32)
    heatmaps: list[tuple[tuple[int, int], np.ndarray]] = []
    k = 1
    if pairs:
        lmax = max(r.emb.shape[0] for r in records)
        k = min(args.topk, _round_capacity(lmax))
        W = max(lmax, k)  # the JAX package pads to _round_capacity(lmax)
        dim = records[0].emb.shape[1]
        embs = np.zeros((N, W, dim), np.float32)
        lens = np.zeros(N, np.int64)
        for i, r in enumerate(records):
            embs[i, : r.emb.shape[0]] = r.emb
            lens[i] = r.emb.shape[0]
        base_kw = {}
        if args.seq_weight > 0.0 and any(r.base_emb is not None for r in records):
            bdim = max(r.base_emb.shape[1] for r in records if r.base_emb is not None)
            base = np.zeros((N, W, bdim), np.float32)
            has_base = np.zeros(N, np.float32)
            for i, r in enumerate(records):
                if r.base_emb is not None and r.base_emb.shape[1] == bdim:
                    base[i, : r.base_emb.shape[0]] = r.base_emb
                    has_base[i] = 1.0
            base_kw = {"base_embs": torch.from_numpy(base).to(device),
                       "has_base": torch.from_numpy(has_base).to(device),
                       "seq_weight": float(args.seq_weight)}
        embs_d = torch.from_numpy(embs).to(device)
        lens_d = torch.from_numpy(lens).to(device)
        bs = max(1, int(args.pair_batch))
        for s in range(0, len(pairs), bs):
            chunk = pairs[s : s + bs]
            ia = torch.tensor([a for a, _ in chunk], device=device)
            ib = torch.tensor([b for _, b in chunk], device=device)
            kv, ki, ex = _pair_posteriors_from_embs(
                embs_d, lens_d, ia, ib, alpha, beta, args.gap_open, args.gap_extend,
                1e-4, args.use_local, k, **base_kw)
            slab_kv.append(kv)
            slab_ki.append(ki)
            pair_chunks.append(chunk)
            ex = ex.cpu().numpy()
            for t, (a, b) in enumerate(chunk):
                expected_scores[a, b] = expected_scores[b, a] = float(ex[t])

    def materialize_post():
        """The slabs as dense per-pair matrices on the host (heatmaps and
        the no-consistency distances)."""
        if post or not pairs:
            return post
        for kv_d, ki_d, chunk in zip(slab_kv, slab_ki, pair_chunks):
            kv = kv_d.cpu().numpy()
            ki = ki_d.cpu().numpy()
            for t, (a, b) in enumerate(chunk):
                la, lb = int(records[a].emb.shape[0]), int(records[b].emb.shape[0])
                Pk = np.zeros((la, lb), np.float32)
                rows_i = np.repeat(np.arange(la), kv.shape[-1])
                vals = kv[t, :la].ravel()
                cols = ki[t, :la].ravel()
                nz = vals > 0
                Pk[rows_i[nz], cols[nz]] = vals[nz]
                post[(a, b)] = Pk
        return post

    if args.plot_diagnostics and pairs:
        mp = materialize_post()
        for (a, b) in pairs[:6]:
            heatmaps.append(((a, b), mp[(a, b)]))

    t_stage = stage_done("posteriors", t_stage)
    want_library = args.dp_score == "library"
    library = None
    lengths = [r.emb.shape[0] for r in records]
    if N >= 3 and args.consistency_rounds > 0 and pairs:
        print(f"Running {args.consistency_rounds} consistency round(s)...")
        out = consistency_rounds_to_distances_from_slabs(
            slab_kv, slab_ki, pair_chunks, N, k, args.consistency_rounds,
            lam=0.5, pmin=1e-4, return_slabs=want_library,
        )
        if want_library:
            D, lib_pairs, lib_v, lib_i = out
            library = PosteriorLibrary(lib_pairs, None, None, lengths,
                                       device_slabs=(lib_v, lib_i))
        else:
            D = out
    else:
        D = build_distance_matrix(materialize_post(), N)
    if want_library and library is None and pairs:
        # no consistency round ran (rounds = 0 or N < 3): the raw pairwise
        # slabs are the library
        library = PosteriorLibrary(
            [pr for chunk in pair_chunks for pr in chunk], None, None, lengths,
            device_slabs=(torch.cat([kv[: len(c)] for kv, c in zip(slab_kv, pair_chunks)]),
                          torch.cat([ki[: len(c)] for ki, c in zip(slab_ki, pair_chunks)])),
        )
    t_stage = stage_done("consistency+distances", t_stage)
    tree = build_guide_tree(D, method=args.tree)
    t_stage = stage_done("guide_tree", t_stage)

    scorer = library.score_matrix if library is not None else None
    if want_library and scorer is None and N >= 2 and pairs:
        print("[WARN] --dp-score library requested but no library available; "
              "falling back to profile scoring.")
    # library-mode progressive DP gap costs: posteriors already price
    # gaps, so the DP default is 0 (override with --dp-gap-open/-extend)
    dp_go = args.gap_open if args.dp_gap_open is None else args.dp_gap_open
    dp_ge = args.gap_extend if args.dp_gap_extend is None else args.dp_gap_extend
    if scorer is not None:
        if args.dp_gap_open is None:
            dp_go = 0.0
        if args.dp_gap_extend is None:
            dp_ge = 0.0

    profiles = initial_profiles(records)
    split: dict = {}
    aln = msa_from_tree(tree, profiles, dp_go, dp_ge, seq_weight=float(args.seq_weight),
                        scorer=scorer, device=device, split=split)
    t_stage = stage_done("progressive_alignment", t_stage)
    refine_stats = None
    refine_split: dict = {}
    if args.refine_iters > 0 and N >= 3:
        print(f"Refining for {args.refine_iters} iteration(s)...")
        t0 = time.perf_counter()
        aln, refine_stats = iterative_refinement(
            aln, profiles, args.refine_iters, np.random.default_rng(args.seed),
            dp_go, dp_ge, seq_weight=float(args.seq_weight), scorer=scorer,
            partitions=tree_partitions(tree, N), min_gain=float(args.refine_min_gain),
            device=device, split=refine_split,
        )
        refine_split["total_s"] = time.perf_counter() - t0

    diagnostics: dict[str, Any] = {
        "expected_scores": expected_scores.tolist(),
        "num_pairs": len(pairs),
        "N": N,
        "alpha": alpha,
        "beta": beta,
        "seq_weight": float(args.seq_weight),
        "input_path": args.input,
        "out_prefix": out_prefix,
        "topk": args.topk,
        "consistency_rounds": args.consistency_rounds,
        "gap_open": args.gap_open,
        "gap_extend": args.gap_extend,
        "tree_method": args.tree,
        "dp_score": args.dp_score,
        "refine_iters": args.refine_iters,
        "seed": args.seed,
        "max_pairs": args.max_pairs,
        "timing_sec": time.time() - t_start,
        "stage_times_sec": stage_times,
        "device": str(device),
        "progressive_split_sec": {k_: v for k_, v in split.items() if k_ != "rounds"},
        "progressive_rounds": len(split.get("rounds", [])),
    }
    if refine_split:
        diagnostics["refinement_split_sec"] = refine_split
    if args.plot_diagnostics and heatmaps:
        diagnostics["posteriors_heatmaps"] = heatmaps
    if refine_stats is not None:
        diagnostics["refinement"] = refine_stats
    if args.use_center is not None and trim_bounds is not None:
        diagnostics["use_center_fraction"] = float(args.use_center)
        diagnostics["center_trim_bounds"] = [[int(s_), int(e)] for s_, e in trim_bounds]
    write_outputs(aln, names, out_prefix, diagnostics)
    print(f"Done. Outputs written to: {out_prefix}.*")


if __name__ == "__main__":
    main()
