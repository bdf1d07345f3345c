"""The port's ``TopKSearcher`` on the CPU, held to ``brute_force_topk`` and
to the JAX package's ``TopKSearcher`` on the same corpus: the cases of
``tests/test_search.py`` with their bars, plus duplicate rows for the
tie rule (score, then the lower corpus index).

The JAX side shards the corpus over the 8 CPU devices of the test mesh
and the port here runs on one device (its default on the CPU), so the
two scan different tiles: they agree on ids up to near-ties, and on
distances within the bars below.  ``tests/test_torch_mesh.py`` holds the
port's 8-shard search to the JAX one."""

import numpy as np
import pytest
import torch

from ginfinity_tpu.parallel.search import TopKSearcher as JSearcher
from ginfinity_tpu.parallel.search import brute_force_topk as jbrute
from ginfinity_tpu_torch.parallel import search as search_mod
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.parallel.search import TopKSearcher, brute_force_topk, recall_at_k

# distances of the scan against a float32 brute force: both are float32
# sums of 64 terms of ~|q|^2 = 64 in another order
TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(1000, 64)).astype(np.float32)
    queries = rng.normal(size=(37, 64)).astype(np.float32)
    return corpus, queries


def _port(corpus, **kw):
    return TopKSearcher(corpus, device="cpu", **kw)


def test_brute_force_and_recall_match_jax(data):
    corpus, queries = data
    for metric in ("sqeuclidean", "cosine", "dot"):
        v, i = brute_force_topk(corpus, queries, 7, metric=metric)
        jv, ji = jbrute(corpus, queries, 7, metric=metric)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(v, jv)
    assert recall_at_k(np.array([[1, 2, 3]]), np.array([[3, 4, 1]])) == pytest.approx(2 / 3)


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
@pytest.mark.parametrize("rescore", ["device", "host"])
def test_exact_vs_brute_force_and_jax(data, metric, rescore):
    corpus, queries = data
    v, i = _port(corpus, metric=metric, query_block=64, rescore=rescore).search(queries, k=10)
    tv, ti = brute_force_topk(corpus, queries, 10, metric=metric)
    assert v.dtype == np.float32 and i.dtype == np.int64 and v.shape == i.shape == (37, 10)
    assert recall_at_k(i, ti) == 1.0
    np.testing.assert_array_equal(i, ti)  # no near-ties in this corpus
    np.testing.assert_allclose(v, tv, rtol=TOL, atol=TOL)
    jv, ji = JSearcher(corpus, metric=metric, query_block=64, rescore=rescore).search(queries, k=10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=TOL, atol=TOL)


def test_sqeuclidean_scores_are_distances(data):
    corpus, queries = data
    v, i = _port(corpus, query_block=64).search(queries[:3], k=5)
    for q in range(3):
        d = np.sum((corpus[i[q]] - queries[q]) ** 2, axis=1)
        np.testing.assert_allclose(v[q], d, rtol=1e-3, atol=1e-3)


def test_distance_is_norm_minus_score_unclamped():
    """A row's distance to itself is ``|q|^2 - (2 q.q - |q|^2)``: it may
    read a little below 0 and stays as computed; the bar scales with
    ``|q|^2 + |c|^2``."""
    rng = np.random.default_rng(5)
    corpus = (rng.normal(size=(300, 128)) / np.sqrt(128)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    v, i = _port(corpus, query_block=64).search(corpus, k=3)
    jv, ji = JSearcher(corpus, query_block=64).search(corpus, k=3)
    np.testing.assert_array_equal(i[:, 0], np.arange(300))
    np.testing.assert_array_equal(i, ji)
    sq = np.sum(corpus * corpus, axis=1)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5 * 2 * sq.max())
    assert np.abs(v[:, 0]).max() <= 1e-5 * 2 * sq.max()


def test_k_clamped_to_corpus():
    corpus = np.eye(5, 8, dtype=np.float32)
    v, i = _port(corpus, query_block=8).search(corpus[:2], k=50)
    assert v.shape == (2, 5)
    # nearest neighbour of a corpus row is itself at distance 0
    assert i[0, 0] == 0 and v[0, 0] < 1e-5
    # the other four rows tie at distance 2: lower index first
    np.testing.assert_array_equal(i[0], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(i[1], [1, 0, 2, 3, 4])


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_compressed_storage_host_rescore_exact(data, storage, metric):
    """Compressed storage + exact float32 host re-score: recall 1.0 on this
    well-separated corpus, exact scores, and the JAX package's ids."""
    corpus, queries = data
    s = _port(corpus, metric=metric, query_block=64, storage=storage, rescore="host")
    v, i = s.search(queries, k=10)
    tv, ti = brute_force_topk(corpus, queries, 10, metric=metric)
    assert recall_at_k(i, ti) == 1.0
    np.testing.assert_allclose(np.sort(v, 1), np.sort(tv, 1), rtol=1e-4, atol=1e-4)
    jv, ji = JSearcher(corpus, metric=metric, query_block=64, storage=storage,
                       rescore="host").search(queries, k=10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(v, jv)  # the same numpy re-score of the same ids


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_int8_device_rescore_recall(data, metric):
    """Device re-score of int8 storage with the residual plane: recall 1.0
    with no host corpus."""
    corpus, queries = data
    s = _port(corpus, metric=metric, query_block=64, storage="int8")
    assert s._host_corpus is None and s._shards[0].resid is not None
    v, i = s.search(queries, k=10)
    tv, ti = brute_force_topk(corpus, queries, 10, metric=metric)
    assert recall_at_k(i, ti) == 1.0
    np.testing.assert_allclose(np.sort(v, 1), np.sort(tv, 1), rtol=1e-3, atol=1e-2)
    jv, _ = JSearcher(corpus, metric=metric, query_block=64, storage="int8").search(queries, k=10)
    np.testing.assert_allclose(np.sort(v, 1), np.sort(jv, 1), rtol=1e-3, atol=1e-2)


def test_int8_quantisation_matches_jax_numpy(data):
    """Corpus rows and their residual plane quantise as the JAX package's
    numpy code does."""
    corpus, _ = data
    s = _port(corpus, storage="int8")
    sc = np.maximum(np.max(np.abs(corpus), axis=1) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(corpus / sc[:, None]), -127, 127).astype(np.int8)
    sh = s._shards[0]
    np.testing.assert_array_equal(sh.corpus[:1000].numpy(), q)
    np.testing.assert_array_equal(sh.scale[:1000].numpy(), sc)
    err = corpus - q.astype(np.float32) * sc[:, None]
    s2 = np.maximum(np.max(np.abs(err), axis=1) / 127.0, 1e-12).astype(np.float32)
    q2 = np.clip(np.rint(err / s2[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(sh.resid[:1000].numpy(), q2)
    np.testing.assert_array_equal(sh.scale2[:1000].numpy(), s2)


def test_int8_gram_is_exact_integer_product():
    """The int8 Gram as float32 products equals the int32 product, also
    when the width needs more than one exact chunk."""
    rng = np.random.default_rng(1)
    corpus = np.sign(rng.normal(size=(40, 1500))).astype(np.float32)  # rows of +-127
    s = _port(corpus, storage="int8", rescore="host")
    q, qs = search_mod._quantize_rows(torch.from_numpy(corpus[:3]))
    got = s._gram(q, qs, 0, 40)
    sh = s._shards[0]
    dots = q.numpy().astype(np.int64) @ sh.corpus[:40].numpy().astype(np.int64).T
    assert np.abs(dots).max() >= 2**24  # beyond one float32 chunk
    want = (dots.astype(np.float32) * qs.numpy()[:, None]) * sh.scale[:40].numpy()[None, :]
    want = 2.0 * want - sh.sqnorm[:40].numpy()[None, :]
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_rescore_k_beyond_candidate_cap(monkeypatch):
    """k above ``_RESCORE_CAND_CAP``: the preselect keeps at least
    ``overfetch * k`` candidates.  The cap is patched down so that the
    preselect runs at a test-sized corpus (several tiles)."""
    monkeypatch.setattr(search_mod, "_RESCORE_CAND_CAP", 32)
    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(70000, 8)).astype(np.float32)
    queries = rng.normal(size=(8, 8)).astype(np.float32)
    s = _port(corpus, query_block=8, storage="int8")
    assert s.corpus_tile * 2 <= s._shards[0].corpus.shape[0], "needs >= 2 tiles"
    v, i = s.search(queries, k=64)
    assert v.shape == (8, 64) and i.shape == (8, 64)
    tv, ti = brute_force_topk(corpus, queries, 64)
    assert recall_at_k(i, ti) >= 0.95
    np.testing.assert_allclose(np.sort(v, 1), np.sort(tv, 1), rtol=1e-3, atol=1e-2)


def test_candidate_recall_is_accepted_and_exact(data):
    """``candidate_recall=None`` (exact candidates in the JAX package) and
    the default give the same result: the port's candidates are exact."""
    corpus, queries = data
    ve, ie = _port(corpus, query_block=64, storage="int8", candidate_recall=None).search(queries, 10)
    va, ia = _port(corpus, query_block=64, storage="int8").search(queries, 10)
    _, ti = brute_force_topk(corpus, queries, 10)
    np.testing.assert_array_equal(ie, ia)
    np.testing.assert_array_equal(ve, va)
    assert recall_at_k(ie, ti) == 1.0


def test_f32_fast_default_vs_host_exact_merge(data):
    """The default (candidates per tile, one merge) and ``rescore='host'``
    (running merge) give the same ids and distances."""
    corpus, queries = data
    fast = _port(corpus, query_block=64)
    exact = _port(corpus, query_block=64, rescore="host")
    assert fast._f32_fast and not exact._f32_fast
    vf, i_f = fast.search(queries, k=10)
    ve, i_e = exact.search(queries, k=10)
    np.testing.assert_array_equal(i_f, i_e)
    np.testing.assert_array_equal(vf, ve)
    for q in range(3):
        d = np.sum((corpus[i_f[q]] - queries[q]) ** 2, axis=1)
        np.testing.assert_allclose(vf[q], d, rtol=1e-3, atol=1e-3)


def test_running_merge_over_many_tiles():
    """Several tiles, k above one tile's share: the running merge, the
    emitted candidates and brute force agree."""
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(20000, 16)).astype(np.float32)
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    fast = _port(corpus, query_block=8)
    exact = _port(corpus, query_block=8, rescore="host")
    assert fast._shards[0].corpus.shape[0] // fast.corpus_tile == 3
    vf, i_f = fast.search(queries, k=300)
    ve, i_e = exact.search(queries, k=300)
    tv, ti = brute_force_topk(corpus, queries, 300)
    np.testing.assert_array_equal(i_f, i_e)
    assert recall_at_k(i_f, ti) == 1.0
    np.testing.assert_allclose(vf, tv, rtol=TOL, atol=TOL)


def test_bf16_precision_f32_storage_rescores_on_device(data):
    corpus, queries = data
    s = _port(corpus, query_block=64, precision="bf16")
    assert s._bf16_rescore and s._host_corpus is None
    v, i = s.search(queries, k=10)
    _, ti = brute_force_topk(corpus, queries, 10)
    assert recall_at_k(i, ti) >= 0.99
    for q in range(4):
        d = np.sum((corpus[i[q]] - queries[q]) ** 2, axis=1)
        np.testing.assert_allclose(v[q], d, rtol=1e-4, atol=1e-5)


def test_bf16_precision_host_is_the_raw_bf16_scan(data):
    """``precision='bf16'`` with ``rescore='host'``: the bf16 Gram alone,
    no re-score, as the JAX package's single bf16 pass."""
    corpus, queries = data
    v, i = _port(corpus, query_block=64, precision="bf16", rescore="host").search(queries, 10)
    _, ti = brute_force_topk(corpus, queries, 10)
    assert recall_at_k(i, ti) >= 0.95
    cb = torch.from_numpy(corpus).to(torch.bfloat16).double().numpy()
    qb = torch.from_numpy(queries).to(torch.bfloat16).double().numpy()
    score = 2 * np.take_along_axis(qb @ cb.T, i, 1) - np.sum(corpus.astype(np.float64) ** 2, 1)[i]
    want = np.sum(queries.astype(np.float64) ** 2, 1)[:, None] - score
    np.testing.assert_allclose(v, want, rtol=0, atol=1e-3)


def test_bf16_device_rescore_recall(data):
    corpus, queries = data
    _, i = _port(corpus, query_block=64, storage="bf16").search(queries, k=10)
    _, ti = brute_force_topk(corpus, queries, 10)
    assert recall_at_k(i, ti) >= 0.99


def test_compressed_scores_are_exact_distances(data):
    corpus, queries = data
    v, i = _port(corpus, query_block=64, storage="int8", rescore="host").search(queries[:4], k=5)
    for q in range(4):
        d = np.sum((corpus[i[q]] - queries[q]) ** 2, axis=1)
        np.testing.assert_allclose(v[q], d, rtol=1e-5, atol=1e-6)


def test_int8_device_rescore_distances_near_exact(data):
    corpus, queries = data
    v, i = _port(corpus, query_block=64, storage="int8").search(queries[:4], k=5)
    for q in range(4):
        d = np.sum((corpus[i[q]] - queries[q]) ** 2, axis=1)
        np.testing.assert_allclose(v[q], d, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("rescore", ["device", "host"])
def test_compressed_uneven_padding(rescore):
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(13, 16)).astype(np.float32)
    v, i = _port(corpus, query_block=4, storage="bf16", rescore=rescore).search(corpus, k=13)
    assert i.max() < 13
    for q in range(13):
        assert i[q, 0] == q


def test_uneven_corpus_padding():
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(13, 16)).astype(np.float32)
    v, i = _port(corpus, query_block=4).search(corpus, k=13)
    # padding rows never appear in results
    assert i.max() < 13
    for q in range(13):
        assert i[q, 0] == q


@pytest.mark.parametrize("kw", [{}, {"rescore": "host"}, {"storage": "bf16", "rescore": "host"},
                                {"storage": "int8", "rescore": "host"}])
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_duplicate_rows_tie_to_lower_index(kw, metric):
    """Rows repeated in the corpus tie exactly; the port orders them by the
    lower index, as ``brute_force_topk``'s stable argsort does, also at the
    k-th place and across tiles.  The JAX package's distances agree."""
    rng = np.random.default_rng(6)
    base = rng.normal(size=(40, 32)).astype(np.float32)
    # each of rows 0-9 four more times, spread over the corpus
    corpus = np.concatenate([base, base[:10], base[:10], base[:10], base[:10]])
    corpus = np.concatenate([corpus, rng.normal(size=(600, 32)).astype(np.float32)])
    queries = np.concatenate([base[:10], base[:10] + 0.01 * rng.normal(size=(10, 32))
                              .astype(np.float32)])
    k = 7  # ties straddle the k-th place: five copies of the nearest row
    v, i = _port(corpus, metric=metric, query_block=8, **kw).search(queries, k)
    _, ti = brute_force_topk(corpus, queries, k, metric=metric)
    np.testing.assert_array_equal(i, ti)
    for q in range(len(queries)):
        assert list(i[q, :5]) == sorted(i[q, :5])  # the five copies, ascending
    jv, _ = JSearcher(corpus, metric=metric, query_block=8, **kw).search(queries, k)
    scale = 2 * np.max(np.sum(corpus ** 2, 1))
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5 * scale)


def test_topk_key_orders_score_then_lower_index():
    scores = torch.tensor([[1.0, -0.0, 0.0, 3.0, 3.0, -2.0, -3e38, 1.0]])
    ids = torch.arange(8)
    v, i = search_mod._topk(scores, ids, 8)
    assert i.tolist() == [[3, 4, 0, 7, 1, 2, 5, 6]]
    assert v.tolist() == torch.tensor([[3.0, 3.0, 1.0, 1.0, -0.0, 0.0, -2.0, -3e38]]).tolist()


def test_argument_errors_and_mesh():
    corpus = np.zeros((4, 8), np.float32)
    for kw in ({"metric": "l1"}, {"precision": "fp8"}, {"storage": "f16"},
               {"rescore": "cloud"}):
        with pytest.raises(ValueError):
            _port(corpus, **kw)

    # a mesh (ported since): two shards of the padded corpus, one merge
    rng = np.random.default_rng(8)
    corpus = rng.normal(size=(300, 8)).astype(np.float32)
    s2 = _port(corpus, mesh=DataMesh(["cpu", "cpu"]), query_block=8)
    assert s2.mesh.size == 2 and [sh.base for sh in s2._shards] == [0, 256]
    v2, i2 = s2.search(corpus[:5], 4)
    v1, i1 = _port(corpus, mesh=DataMesh(["cpu"]), query_block=8).search(corpus[:5], 4)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(v2, v1, rtol=0, atol=1e-5)
    assert _port(corpus[:4], mesh=DataMesh(["cpu"])).n == 4
