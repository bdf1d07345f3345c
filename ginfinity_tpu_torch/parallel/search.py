"""Exact top-k similarity search over an embedding corpus sharded over a
data mesh.

Port of ``ginfinity_tpu/parallel/search.py``.  As there, the corpus
shards over every visible device by default (``parallel/mesh.py``; one
device on the CPU): it is padded to ``size * corpus_tile`` rows, each
device holds one contiguous block of whole tiles, and each query block
is scanned on every shard, tile by tile:

    [Q, tile] Gram  ->  tile top-k  ->  a running merge, or candidates
    emitted per tile and merged once

so the ``[Q, N]`` score matrix never exists whole.  Each shard returns
its top ``k`` with corpus-global ids; the shards' candidates are
gathered onto the first device in shard order and a final top-k is
taken over them.  Compressed storage (bf16, or int8 with per-row scales)
over-fetches candidates and re-scores them in float32, on the device or
on the host.

Scores.  ``sqeuclidean`` ranks by ``2 q.c - ||c||^2`` and reports the
distance ``||q||^2 - score``, as the JAX package does: the distance is not
recomputed as ``sum((q - c)^2)`` and is not clamped at 0, so a row's
distance to itself may read a little below 0.  ``cosine`` normalises rows
(norm floored at 1e-12) and ranks by the dot product, as ``dot`` does.

Ties.  Every selection ranks by score and then by the lower corpus
index, the order of ``brute_force_topk``'s stable ``argsort``: the key of
a score is its float32 bits, made monotone, above the complement of its
index, in one int64, so ``torch.topk`` sees no two keys equal.

``torch.topk`` is exact, so the scan needs no counterpart of the JAX
package's ``approx_max_k`` candidate generation: ``candidate_recall`` is
accepted and does nothing, and the default mode returns the exact top-k.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.parallel.mesh import make_data_mesh
from ginfinity_tpu_torch.utils.device import disable_tf32

_NEG = -3.0e38
# most candidates a query sends to the compressed modes' device re-score
# (``[cap, D]`` float32 rows gathered per query)
_RESCORE_CAND_CAP = 2048
# int8 Gram as float32 products: every partial sum of a chunk of this many
# terms is an integer below 127^2 * 1024 < 2^24, so it is exact
_INT8_CHUNK = 1024


def _topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best ``(score, id)`` of each row, by score and then by the
    lower id; ``ids`` broadcasts against ``scores`` (ids below 2^31)."""
    bits = (scores + 0.0).view(torch.int32)  # + 0.0 folds -0.0 into 0.0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key = ordered * 2**32 + (2**32 - 1 - ids.to(torch.int64))
    pos = torch.topk(key, k, dim=1).indices
    return scores.gather(1, pos), ids.expand_as(scores).gather(1, pos)


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """Float32 tensor of ``x`` rounded to bfloat16: a float32 product of
    two such values is exact, so a float32 Gram of them is the bf16 x bf16
    -> float32 product."""
    return x.to(torch.bfloat16).to(torch.float32)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation: ``(q, scale)`` with
    ``x ~ q * scale``."""
    s = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def _normalise(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


class _Shard:
    """One device's block of the padded corpus: rows ``base`` to ``base +
    rows - 1`` in the storage mode, with their validity, float32 squared
    norms and int8 scales."""

    def __init__(self, x: torch.Tensor, n_valid: int, base: int, storage: str,
                 rescore: str):
        self.base = base
        self.device = x.device
        self.valid = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        self.valid[:n_valid] = True
        self.sqnorm = (x * x).sum(dim=1)
        self.scale = self.resid = self.scale2 = None
        if storage == "bf16":
            self.corpus = x.to(torch.bfloat16)
        elif storage == "int8":
            self.corpus, self.scale = _quantize_rows(x)
            if rescore == "device":
                # the rounding error, quantised again: rows rebuild to ~int16
                err = x - self.corpus.to(torch.float32) * self.scale[:, None]
                self.resid, self.scale2 = _quantize_rows(err)
        else:
            self.corpus = x


class TopKSearcher:
    """Exact top-k search of a corpus sharded over a data mesh.

    Parameters, as the JAX package's:

    corpus : ``[N, D]`` float32 embeddings.
    metric : ``'sqeuclidean'`` | ``'cosine'`` | ``'dot'``.
    mesh : a ``parallel/mesh.py`` mesh; by default every device visible
        to ``device`` (``make_data_mesh``).
    query_block : queries per scan; the last block is zero-padded.
    precision : Gram precision for f32 storage, ``'highest'`` (float32
        products) or ``'bf16'`` (bf16 products, float32 sums).
    storage : the corpus on the device, ``'f32'``, ``'bf16'`` or
        ``'int8'`` (per-row scales).
    overfetch : candidate multiplier for compressed storage.
    rescore : ``'device'`` (default) or ``'host'``.  With f32 storage and
        ``'highest'``, ``'device'`` emits per-tile candidates and merges
        them once, ``'host'`` keeps a running merge; both are exact.
        With bf16 precision on f32 storage, ``'device'`` re-scores bf16
        candidates exactly in float32.  Compressed storage re-scores its
        over-fetched candidates on the device from the stored rows (int8
        adds a residual int8 plane, for ~int16 accuracy) or on the host
        against a float32 copy of the corpus.
    candidate_recall : accepted for the JAX package's signature; the
        candidates are exact here.
    device : without ``mesh``, the device whose visible devices the
        corpus shards over: the CUDA device (every card) unless ``'cpu'``
        is asked for.
    """

    def __init__(
        self,
        corpus: np.ndarray,
        metric: str = "sqeuclidean",
        mesh=None,
        query_block: int = 1024,
        precision: str = "highest",
        storage: str = "f32",
        overfetch: int = 4,
        rescore: str = "device",
        candidate_recall: float | None = 0.99,
        device=None,
    ):
        if metric not in ("sqeuclidean", "cosine", "dot"):
            raise ValueError(f"unknown metric {metric!r}")
        if precision not in ("highest", "bf16"):
            raise ValueError(f"precision must be 'highest' or 'bf16', got {precision!r}")
        if storage not in ("f32", "bf16", "int8"):
            raise ValueError(f"storage must be 'f32'|'bf16'|'int8', got {storage!r}")
        if rescore not in ("device", "host"):
            raise ValueError(f"rescore must be 'device'|'host', got {rescore!r}")
        self.mesh = mesh if mesh is not None else make_data_mesh(device=device)
        self.device = self.mesh.first
        if any(d.type == "cuda" for d in self.mesh.devices):
            disable_tf32()
        self.metric = metric
        self.precision = precision
        self.storage = storage
        self.overfetch = max(1, int(overfetch))
        self.rescore = rescore
        # f32 storage, bf16 products: candidates re-scored exactly on the device
        self._bf16_rescore = storage == "f32" and precision == "bf16" and rescore == "device"
        # f32 storage, float32 products, the default: candidates emitted per
        # tile are exact scores already and are merged once
        self._f32_fast = storage == "f32" and precision == "highest" and rescore == "device"
        self._dev_rescore = (storage != "f32" and rescore == "device") or self._bf16_rescore
        self.n, self.dim = corpus.shape
        self.query_block = query_block

        corpus = np.asarray(corpus, np.float32)
        if metric == "cosine":
            corpus = _normalise(corpus)
        self._host_corpus = corpus if (storage != "f32" and rescore == "host") else None
        # each shard holds whole tiles, sized from its share of the rows
        n_dev = self.mesh.size
        self.corpus_tile = min(8192, max(256, 1 << (-(-self.n // n_dev) - 1).bit_length()))
        step = n_dev * self.corpus_tile
        self._padded_n = -(-self.n // step) * step
        rows = self._padded_n // n_dev
        self._shards = []
        for s, dev in enumerate(self.mesh.devices):
            lo, hi = min(self.n, s * rows), min(self.n, (s + 1) * rows)
            x = torch.zeros((rows, self.dim), dtype=torch.float32, device=dev)
            x[: hi - lo] = torch.from_numpy(corpus[lo:hi]).to(dev)
            self._shards.append(_Shard(x, hi - lo, s * rows, storage, rescore))

    # -- the scan ------------------------------------------------------------

    def _query_matrix(self, q: torch.Tensor):
        """The queries as the Gram reads them, with their int8 scales."""
        if self.storage == "int8":
            return _quantize_rows(q)
        if self.storage == "bf16" or self.precision == "bf16":
            return _bf16_values(q), None
        return q, None

    def _gram(self, q_mat: torch.Tensor, q_scale, lo: int, hi: int,
              sh: _Shard | None = None) -> torch.Tensor:
        """``[Q, hi - lo]`` float32 scores of the queries against rows
        ``lo:hi`` of shard ``sh`` (the first by default)."""
        sh = sh or self._shards[0]
        c = sh.corpus[lo:hi]
        if self.storage == "int8":
            qf, cf = q_mat.to(torch.float32), c.to(torch.float32)
            dots = sum((qf[:, s:s + _INT8_CHUNK] @ cf[:, s:s + _INT8_CHUNK].T).to(torch.int32)
                       for s in range(0, self.dim, _INT8_CHUNK))
            scores = dots.to(torch.float32) * q_scale[:, None] * sh.scale[None, lo:hi]
        else:
            c = _bf16_values(c) if self.precision == "bf16" else c.to(torch.float32)
            scores = q_mat @ c.T
        if self.metric == "sqeuclidean":
            # maximise 2 q.c - ||c||^2, which minimises ||q - c||^2
            scores = 2.0 * scores - sh.sqnorm[None, lo:hi]
        return torch.where(sh.valid[None, lo:hi], scores, _NEG)

    def _scan(self, q: torch.Tensor, k_tile: int, merge_k: int | None = None,
              sh: _Shard | None = None):
        """Each tile's top ``k_tile`` ``(scores, ids)`` of each query: all
        tiles' candidates side by side, or, with ``merge_k``, the top
        ``merge_k`` of a merge after each tile.  Ids are rows of shard
        ``sh`` (the first by default)."""
        sh = sh or self._shards[0]
        q_mat, q_scale = self._query_matrix(q)
        tile = self.corpus_tile
        vals, ids = [], []
        for lo in range(0, sh.corpus.shape[0], tile):
            scores = self._gram(q_mat, q_scale, lo, lo + tile, sh)
            row_ids = torch.arange(lo, lo + tile, device=q.device)
            tv, ti = _topk(scores, row_ids, min(k_tile, tile))
            vals.append(tv)
            ids.append(ti)
            if merge_k is not None:
                v, i = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
                v, i = _topk(v, i, min(merge_k, v.shape[1]))
                vals, ids = [v], [i]
        return torch.cat(vals, dim=1), torch.cat(ids, dim=1)

    def _k_tile(self, k: int) -> int:
        """Candidates a tile emits for a top ``k``.  The JAX package's count,
        ``max(k, overfetch * k // 4)``, meets the over-fetch through many
        tiles (or shards); a corpus of a few tiles in all emits
        ``overfetch * k`` candidates in all instead."""
        n_tiles = self._padded_n // self.corpus_tile
        k_tile = max(k, self.overfetch * k // 4, -(-min(self.n, self.overfetch * k) // n_tiles))
        return min(k_tile, self.corpus_tile)

    def _refine(self, q: torch.Tensor, cv: torch.Tensor, ci: torch.Tensor, k: int,
                sh: _Shard | None = None):
        """Candidates re-scored in float32 from the stored rows of shard
        ``sh`` (the first by default); the top ``k`` by the refined score
        (for ``sqeuclidean`` minus the distance)."""
        sh = sh or self._shards[0]
        # at least overfetch * k candidates survive the preselect (the JAX
        # package keeps k on each of its shards)
        cap = max(_RESCORE_CAND_CAP, min(self.overfetch * k, self.n))
        if cv.shape[1] > cap:
            cv, ci = _topk(cv, ci, cap)
        rows = sh.corpus[ci].to(torch.float32)  # [Q, C, D]
        if self.storage == "int8":
            rows = rows * sh.scale[ci][..., None]
            rows = rows + sh.resid[ci].to(torch.float32) * sh.scale2[ci][..., None]
        if self.metric == "sqeuclidean":
            d = rows - q[:, None, :]
            refined = -(d * d).sum(dim=-1)
        else:
            refined = torch.bmm(rows, q[:, :, None])[..., 0]
        refined = torch.where(cv > _NEG / 2, refined, _NEG)
        return _topk(refined, ci, min(k, refined.shape[1]))

    def _shard_block(self, sh: _Shard, q: torch.Tensor, k: int):
        """Shard ``sh``'s top ``k`` ``(scores, ids)`` of one padded query
        block (fewer when it holds fewer candidates), best first, with
        corpus-global ids."""
        if self._dev_rescore:
            v, i = self._refine(q, *self._scan(q, self._k_tile(k), sh=sh), k, sh=sh)
        elif self.storage == "f32" and not self._f32_fast:
            v, i = self._scan(q, k, merge_k=k, sh=sh)
        else:
            cv, ci = self._scan(q, self._k_tile(k) if self._f32_fast else k, sh=sh)
            v, i = _topk(cv, ci, min(k, cv.shape[1]))
        return v, i + sh.base

    def _search_block(self, q: torch.Tensor, k: int):
        """The top ``k`` ``(scores, ids)`` of one padded query block on the
        first device, best first: each shard's candidates, gathered in
        shard order and merged."""
        parts = [self._shard_block(sh, q.to(sh.device), k) for sh in self._shards]
        if len(parts) == 1:
            return parts[0]
        v = torch.cat([p[0].to(self.device) for p in parts], dim=1)
        i = torch.cat([p[1].to(self.device) for p in parts], dim=1)
        return _topk(v, i, k)

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """``(scores [Q, k] float32, ids [Q, k] int64)`` of the top-k corpus
        rows of each query, best first; for ``sqeuclidean`` the scores are
        squared distances, ascending.  Compressed storage with
        ``rescore='host'`` takes ``overfetch * k`` candidates from the
        device and re-scores them on the host against the float32
        corpus."""
        k = min(k, self.n)
        host_rescore = self.storage != "f32" and self.rescore == "host"
        k_dev = min(self.n, self.overfetch * k) if host_rescore else k
        queries = np.asarray(queries, np.float32)
        if self.metric == "cosine":
            queries = _normalise(queries)
        nq = queries.shape[0]
        out_v = np.empty((nq, k_dev), np.float32)
        out_i = np.empty((nq, k_dev), np.int64)
        block = self.query_block
        with torch.no_grad():
            for s in range(0, nq, block):
                m = min(block, nq - s)
                q = np.zeros((block, self.dim), np.float32)
                q[:m] = queries[s: s + m]
                v, i = self._search_block(torch.from_numpy(q).to(self.device), k_dev)
                out_v[s: s + m] = v[:m].cpu().numpy()
                out_i[s: s + m] = i[:m].cpu().numpy()

        if host_rescore:
            return self._rescore_exact(queries, out_i, k)
        if self.metric == "sqeuclidean":
            if self._dev_rescore:
                return -out_v, out_i  # the refined score was minus the distance
            # the score was 2 q.c - ||c||^2; the distance is ||q||^2 - score
            out_v = np.sum(queries * queries, axis=1)[:, None] - out_v
        return out_v, out_i

    def _rescore_exact(self, queries: np.ndarray, cand_ids: np.ndarray,
                       k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact float32 re-score of the device's candidates against the
        host corpus; ranks the candidate set exactly."""
        rows = self._host_corpus[cand_ids]  # [Q, kf, D]
        if self.metric == "sqeuclidean":
            vals = np.sum((rows - queries[:, None, :]) ** 2, axis=2, dtype=np.float32)
            order = np.argsort(vals, axis=1, kind="stable")[:, :k]
        else:
            vals = np.einsum("qd,qkd->qk", queries, rows).astype(np.float32)
            order = np.argsort(-vals, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(vals, order, axis=1), np.take_along_axis(cand_ids, order, axis=1)


def brute_force_topk(corpus: np.ndarray, queries: np.ndarray, k: int,
                     metric: str = "sqeuclidean") -> tuple[np.ndarray, np.ndarray]:
    """NumPy reference for recall checks (small inputs only); ties go to
    the lower index."""
    if metric == "cosine":
        corpus, queries = _normalise(corpus), _normalise(queries)
    if metric == "sqeuclidean":
        d = (
            np.sum(queries**2, 1)[:, None]
            - 2 * queries @ corpus.T
            + np.sum(corpus**2, 1)[None, :]
        )
        idx = np.argsort(d, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(d, idx, axis=1), idx
    s = queries @ corpus.T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def recall_at_k(found: np.ndarray, truth: np.ndarray) -> float:
    """Fraction of true top-k ids recovered (order-insensitive)."""
    hits = 0
    for f, t in zip(found, truth):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / truth.size
