"""The port's data mesh (``--data-parallel``) against the JAX package's
8-device CPU mesh (``tests/conftest.py``), and the package surface.

The port runs one process over a list of devices; here the list is k
CPU entries, put in place of ``parallel/mesh.py::visible_devices`` (the
one function through which a mesh learns the devices) or given as a
``DataMesh``.  Bars:

- sharded graph and window rows: the JAX sharded rows within 1e-5 (the
  graph rows with the float64 tie-break of ``test_torch_graph_embed``),
  the port's own unsharded rows exactly;
- align-batch: scores, paths and codes identical to JAX's mesh path; the
  ``--data-parallel`` CLI byte-identical to JAX's;
- search: neighbours and order identical to JAX's 8-device search in
  f32, the recall bars of ``tests/test_search.py`` in bf16 and int8;
- MSA: sharded posteriors and consistency rounds equal to the unsharded
  ones; the ``--data-parallel`` CLI writes JAX's files (or a guide-tree
  flip within float32 noise, ROADMAP F2, and JAX's bytes from JAX's
  tree);
- training: one sharded step against JAX's sharded step at dropout 0
  (loss 1e-6 relative; gradients 1e-5 x max(1, max|g|) with the float64
  tie-break of ``test_torch_training``, batch norm's averaged running
  statistics 1e-6), a 1-shard mesh step bit-equal to the unsharded step,
  and the ``--data-parallel`` triplet CLI's per-epoch losses within 1e-4
  relative at lr 1e-4."""

import contextlib
import importlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.ops import dp as jdp
from ginfinity_tpu.parallel.mesh import make_data_mesh as jmesh
from ginfinity_tpu.parallel.search import TopKSearcher as JSearcher
from ginfinity_tpu.pipelines import align_batch as jalign_batch
from ginfinity_tpu.pipelines import engine as jengine
from ginfinity_tpu.pipelines import fast_windows as jfw
from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu.pipelines.node_embed import serialize_matrix
from ginfinity_tpu.training import data as JD
from ginfinity_tpu.training import train as JT
from ginfinity_tpu_torch.graphs import batching
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.gine import GINConfig, _leaves
from ginfinity_tpu_torch.ops import dp
from ginfinity_tpu_torch.ops import pairhmm
from ginfinity_tpu_torch.parallel import mesh as mesh_mod
from ginfinity_tpu_torch.parallel.mesh import DataMesh, data_parallel_mesh, make_data_mesh
from ginfinity_tpu_torch.parallel.search import TopKSearcher, brute_force_topk, recall_at_k
from ginfinity_tpu_torch.pipelines import align_batch, engine
from ginfinity_tpu_torch.pipelines import fast_windows as fw
from ginfinity_tpu_torch.pipelines import msa as tmsa
from ginfinity_tpu_torch.training import data as D
from ginfinity_tpu_torch.training import train as T
from ginfinity_tpu_torch.training import train_cli as cli

from test_torch_fast_windows import FLAGSHIP_SMALL, _corpus, _pair
from test_torch_graph_embed import STRUCTURES, _batch64, _config, _float64, _hold, _models
from test_torch_graph_embed import _structures as _graph_structures
from test_torch_msa import _assert_flip_is_noise, _family_tsv, _files, _spy
from test_torch_train_cli import _log_losses, _model_kw, _run_both
from torch_train_data import jax_init, structures

CPU = torch.device("cpu")
TOL = 1e-5


def _cpus(k):
    return DataMesh([CPU] * k)


@pytest.fixture
def eight(monkeypatch):
    """Every entry point sees 8 CPU devices, as the JAX side does."""
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda device: [device] * 8)


# -- the package surface --------------------------------------------------------


@pytest.mark.parametrize("sub", ["", ".graphs", ".models", ".ops", ".utils", ".parallel",
                                 ".training"])
def test_every_jax_export_imports_from_the_port(sub):
    jax_pkg = importlib.import_module("ginfinity_tpu" + sub)
    port = importlib.import_module("ginfinity_tpu_torch" + sub)
    missing = [n for n in jax_pkg.__all__ if n not in port.__all__ or not hasattr(port, n)]
    assert not missing


# -- the mesh ---------------------------------------------------------------------


def test_mesh_devices_blocks_and_collectives(monkeypatch):
    assert make_data_mesh(device="cpu").devices == (CPU,)
    assert data_parallel_mesh(CPU) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh_mod.visible_devices(torch.device("cuda", 0)) == [
        torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda device: [device] * 8)
    m = make_data_mesh(device="cpu")
    assert m.size == 8 and m.first == CPU and data_parallel_mesh(CPU).size == 8
    assert make_data_mesh(3, device="cpu").size == 3
    # 13 items pad to 16: blocks of 2, the padded tail dropped
    assert [(b.start, b.stop) for b in m.blocks(13)] == [
        (0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 13), (13, 13)]
    x = torch.arange(16.0)
    parts = m.split(x)
    assert [p.tolist() for p in parts[:2]] == [[0.0, 1.0], [2.0, 3.0]]
    assert torch.equal(m.gather(parts, 13), x[:13])
    with pytest.raises(ValueError):
        m.split(x[:13])
    made = []
    assert m.replicate(lambda d: made.append(d) or len(made)) == [1] * 8 and made == [CPU]
    vals = [torch.tensor([0.1, 1e8], dtype=torch.float32), torch.tensor([0.2, 1.0]),
            torch.tensor([0.3, -1e8])]
    want = (vals[0] + vals[1]) + vals[2]
    assert torch.equal(DataMesh([CPU] * 3).mean(vals), want / 3)


# -- graph and window embedding -----------------------------------------------------


def test_sharded_engine_matches_jax_and_unsharded():
    """The JAX engine's ``forward_stacked_sharded`` over 8 devices and the
    port's engine over 8 shards: many small batches, so every shard runs
    several."""
    jm, pm = _models(_config())
    structs = STRUCTURES + _graph_structures(seed=9, n=14)
    graphs = engine.preprocess_structures(structs).graphs
    jgraphs = jengine.preprocess_structures(structs).graphs
    ref = jengine.InferenceEngine(jm, max_nodes_per_batch=60, mesh=jmesh()).embed_graphs(jgraphs)
    eng = engine.InferenceEngine(pm, max_nodes_per_batch=60, mesh=_cpus(8))
    work = eng._sharded(list(eng._batches(graphs)))
    assert len({s for s, _, _ in work}) >= 4 and len(work) >= 12
    got = eng.embed_graphs(graphs)
    alone = engine.InferenceEngine(pm, max_nodes_per_batch=60, device="cpu").embed_graphs(graphs)
    np.testing.assert_array_equal(got, alone)
    x64 = gine.forward_once(pm.config, _float64(pm.params), _float64(pm.state),
                            _batch64(batching.batch_graphs(graphs))).numpy()
    _hold(got, ref, x64)


@pytest.mark.parametrize("kw", [{}, {"max_programs": 1}], ids=["ladder", "merged"])
def test_sharded_windows_match_jax_and_unsharded(kw):
    jm, pm = _pair(FLAGSHIP_SMALL)
    structs = _corpus(seed=4, n=8)
    ref = jfw.embed_corpus_windows(jm, structs, 40, True, mesh=jmesh(), **kw)
    got = fw.embed_corpus_windows(pm, structs, 40, True, mesh=_cpus(8), **kw)
    alone = fw.embed_corpus_windows(pm, structs, 40, True, device="cpu", **kw)
    assert sum(s.size for s, _ in got) > 500
    for (s0, e0), (s1, e1), (s2, e2) in zip(ref, got, alone):
        np.testing.assert_array_equal(s1, s0)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_allclose(e1, e0, atol=TOL, rtol=0)


def test_sharded_compact_windows_equal_unsharded(monkeypatch):
    """A layer-norm model takes the compact path: its chunks shard too."""
    _, pm = _pair(FLAGSHIP_SMALL)
    cfg = GINConfig.create(**{**FLAGSHIP_SMALL, "norm_type": "layer"})
    odd = gine.GINModel(cfg, pm.params, pm.state)
    structs = _corpus(seed=5, n=6)
    monkeypatch.setattr(fw, "_COMPACT_CHUNK_NODES", 2000)  # several chunks a group
    got = fw.embed_corpus_windows(odd, structs, 40, True, mesh=_cpus(3))
    alone = fw.embed_corpus_windows(odd, structs, 40, True, device="cpu")
    for (s0, e0), (s1, e1) in zip(alone, got):
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(e0, e1)


# -- align-batch ---------------------------------------------------------------------


def _mats(seed=0, n=13):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(5, 40)), int(rng.integers(5, 40))))
            .astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("mode", ["global", "local"])
def test_align_batch_mesh_matches_jax(mode, monkeypatch):
    """13 pairs pad to 16 on 8 shards (``tests/test_multichip.py``)."""
    mats = _mats()
    want = jdp.affine_align_batch(mats, -1.0, -0.5, mode, mesh=jmesh())
    seen = []
    real = dp.paths_from_codes
    monkeypatch.setattr(dp, "paths_from_codes", lambda codes, *a: seen.append(codes) or
                        real(codes, *a))
    got = dp.affine_align_batch(mats, -1.0, -0.5, mode, mesh=_cpus(8))
    alone = dp.affine_align_batch(mats, -1.0, -0.5, mode, device="cpu")
    assert got == alone
    assert np.array_equal(seen[0], seen[1]) and seen[0].shape[0] == 13
    assert [s for s, _ in got] == [s for s, _ in want]
    assert [p for _, p in got] == [p for _, p in want]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("mode", ["global", "local"])
def test_align_batch_cli_data_parallel_byte_identical(mode, eight, tmp_path, capsys):
    rng = np.random.default_rng(1)
    with open(tmp_path / "emb.tsv", "w") as f:
        f.write("id\tnode_embeddings\n")
        for k in range(6):
            m = rng.standard_normal((int(rng.integers(10, 25)), 8)).astype(np.float32)
            f.write(f"r{k}\t{serialize_matrix(m)}\n")
    args = ["--input", str(tmp_path / "emb.tsv"), "--id-column", "id", "--mode", mode,
            "--batch-size", "5", "--write-alignment", "--data-parallel"]
    jalign_batch.main([*args, "--output-dir", str(tmp_path / "jax")])
    align_batch.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "[align-batch] data parallel over 8 devices" in capsys.readouterr().out
    ref, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(ref) and len(ref) == 1 + 15
    for name in ref:
        assert got[name] == ref[name], name


# -- search ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1000, 64)).astype(np.float32),
            rng.normal(size=(37, 64)).astype(np.float32))


@pytest.mark.parametrize("rescore", ["device", "host"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_search_on_8_shards_matches_jax(data, metric, rescore):
    corpus, queries = data
    s = TopKSearcher(corpus, metric=metric, mesh=_cpus(8), query_block=64, rescore=rescore)
    assert [sh.base for sh in s._shards] == [k * 256 for k in range(8)]
    v, i = s.search(queries, k=10)
    jv, ji = JSearcher(corpus, metric=metric, query_block=64, rescore=rescore).search(queries,
                                                                                      k=10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-4)


# each mode's bars in tests/test_search.py: recall, and the distances'
# (rtol, atol) where it checks them
COMPRESSED = {("bf16", "device"): (0.99, None), ("bf16", "host"): (1.0, 1e-4),
              ("int8", "device"): (1.0, 1e-3), ("int8", "host"): (1.0, 1e-4)}


@pytest.mark.parametrize("storage,rescore", list(COMPRESSED))
def test_search_compressed_on_8_shards_recall(data, storage, rescore):
    corpus, queries = data
    v, i = TopKSearcher(corpus, mesh=_cpus(8), query_block=64, storage=storage,
                        rescore=rescore).search(queries, k=10)
    tv, ti = brute_force_topk(corpus, queries, 10)
    bar, rtol = COMPRESSED[storage, rescore]
    assert recall_at_k(i, ti) >= bar
    if rtol is not None:
        np.testing.assert_allclose(np.sort(v, 1), np.sort(tv, 1), rtol=rtol,
                                   atol=1e-2 if rtol == 1e-3 else 1e-4)


def test_search_default_mesh_and_ties_across_shards(eight):
    """By default the corpus shards over every visible device, as JAX's
    does; exact duplicates in different shards tie to the lower index."""
    rng = np.random.default_rng(6)
    base = rng.normal(size=(10, 16)).astype(np.float32)
    corpus = rng.normal(size=(600, 16)).astype(np.float32)
    for pos in (3, 300, 599):
        corpus[pos] = base[0]
    s = TopKSearcher(corpus, device="cpu", query_block=8)
    assert s.mesh.size == 8 and len({sh.base for sh in s._shards}) == 8
    v, i = s.search(base[:1], k=4)
    assert i[0, :3].tolist() == [3, 300, 599]
    np.testing.assert_array_equal(i, brute_force_topk(corpus, base[:1], 4)[1])


# -- MSA ---------------------------------------------------------------------------


def _msa_inputs(seed=3, N=7, W=40, d=8):
    rng = np.random.default_rng(seed)
    lens = rng.integers(12, W + 1, size=N)
    embs = np.zeros((N, W, d), np.float32)
    for i, n in enumerate(lens):
        e = rng.normal(size=(n, d)).astype(np.float32)
        embs[i, :n] = e / np.linalg.norm(e, axis=1, keepdims=True)
    pairs = [(a, b) for a in range(N) for b in range(a + 1, N)]
    return torch.from_numpy(embs), torch.from_numpy(lens), pairs


@pytest.mark.parametrize("local", [False, True])
def test_sharded_posteriors_equal_unsharded(local):
    embs, lens, pairs = _msa_inputs()
    ia = torch.tensor([a for a, _ in pairs])
    ib = torch.tensor([b for _, b in pairs])
    mesh = _cpus(3)
    want = pairhmm._pair_posteriors_from_embs(embs, lens, ia, ib, 5.0, 0.0, -10.0, -0.5, 1e-4,
                                              local, 16)
    got = pairhmm.pair_posteriors_from_embs_sharded(
        mesh, mesh.replicate(lambda d: embs), mesh.replicate(lambda d: lens), ia, ib, 5.0,
        0.0, -10.0, -0.5, 1e-4, local, 16)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_sharded_consistency_rounds_equal_unsharded(monkeypatch):
    embs, lens, pairs = _msa_inputs(seed=4)
    ia = torch.tensor([a for a, _ in pairs])
    ib = torch.tensor([b for _, b in pairs])
    kv, ki, _ = pairhmm._pair_posteriors_from_embs(embs, lens, ia, ib, 5.0, 0.0, -10.0, -0.5,
                                                   1e-4, False, 16)
    monkeypatch.setattr(tmsa, "_PAIR_BLOCK", 4)  # 21 pairs: 6 blocks over the shards
    want = tmsa._consistency_rounds_on_slabs(kv, ki, pairs, 7, 2, 0.5, 1e-4, 16)
    got = tmsa._consistency_rounds_on_slabs(kv, ki, pairs, 7, 2, 0.5, 1e-4, 16, _cpus(4))
    assert not torch.equal(want[0], kv)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _msa_run(monkeypatch, mod, argv, prefix):
    """A CLI run: its stdout, and the D and tree of its guide tree."""
    log = []
    _spy(monkeypatch, mod, "build_guide_tree", log)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mod.main(argv + ["--out-prefix", str(prefix)])
    (D, tree), = [(a[0], o) for a, _, o in log]
    return out.getvalue(), D, tree


@pytest.mark.parametrize("mode", ["library", "profile"])
def test_msa_cli_data_parallel_matches_jax(mode, eight, tmp_path, monkeypatch):
    """JAX's ``--data-parallel`` over 8 devices and the port's over 8
    shards; the port's own unsharded run writes the same bytes."""
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    src = _family_tsv(tmp_path / "f.tsv", n=7, lmax=30, structure=True, base=True)
    argv = ["--input", src, "--dp-score", mode, "--seq-weight", "0.5", "--base-embeds-col",
            "base_embeddings", "--data-parallel"]
    tree_fn = tmsa.build_guide_tree
    jout, jD, jtree = _msa_run(monkeypatch, jmsa, argv, tmp_path / "jax" / "msa")
    out, tD, ttree = _msa_run(monkeypatch, tmsa, argv + ["--device", "cpu"],
                              tmp_path / "port" / "msa")
    assert "[embed_msa] data parallel over 8 devices" in jout and \
        "[embed_msa] data parallel over 8 devices" in out
    # the port alone, and over 8 shards with batches of 8 pairs (three
    # posterior batches; JAX's mesh path takes one batch here)
    runs = {"port": tD}
    for name, devices, extra in (("alone", 1, []), ("batched", 8, ["6"]),
                                 ("batched_alone", 1, ["6"])):
        monkeypatch.setattr(mesh_mod, "visible_devices", lambda device, k=devices: [device] * k)
        monkeypatch.setattr(tmsa, "build_guide_tree", tree_fn)
        batch = ["--pair-batch", *extra] if extra else []
        _, runs[name], _ = _msa_run(monkeypatch, tmsa, argv + batch + ["--device", "cpu"],
                                    tmp_path / name / "msa")
    for a, b in (("alone", "port"), ("batched_alone", "batched")):
        np.testing.assert_array_equal(runs[a], runs[b])
        assert _files(tmp_path / a / "msa") == _files(tmp_path / b / "msa")
    monkeypatch.setattr(tmsa, "build_guide_tree", tree_fn)
    if ttree != jtree:
        _assert_flip_is_noise(jD, tD, "nj")
        monkeypatch.setattr(tmsa, "build_guide_tree", lambda D, method="nj": jtree)
        tmsa.main(argv + ["--device", "cpu", "--out-prefix", str(tmp_path / "given" / "msa")])
        assert _files(tmp_path / "given" / "msa") == _files(tmp_path / "jax" / "msa")
    else:
        assert _files(tmp_path / "port" / "msa") == _files(tmp_path / "jax" / "msa")


# -- training ----------------------------------------------------------------------


def _triplet_rows(rng, n):
    return {c: structures(rng, n, 14, 40) for c in ("anchor", "positive", "negative")}


def _triplet_datasets(n=24, seed=5):
    import pandas as pd

    from ginfinity_tpu_torch.utils.io import Table

    rows = _triplet_rows(np.random.default_rng(seed), n)
    cols = {f"{c}_structure": v for c, v in rows.items()}
    table = Table(list(cols), [dict(zip(cols, vals)) for vals in zip(*cols.values())])
    return JD.TripletDataset(pd.DataFrame(cols)), D.TripletDataset(table)


def _stacked(n_dev, seed=0):
    """The same first stack of n_dev triplet batches in both packages."""
    jds, pds = _triplet_datasets()
    jb, js = next(JD.iter_graph_pair_batches_dp(jds, 3, n_dev, np.random.default_rng(seed),
                                                JD._triplet_batch))
    pb, ps = next(D.iter_graph_pair_batches_dp(pds, 3, n_dev, np.random.default_rng(seed),
                                               D._triplet_batch))
    assert js and ps
    return jb, pb


def _cast(batch, dtype):
    import dataclasses

    if isinstance(batch, torch.Tensor):
        return batch.to(dtype) if batch.is_floating_point() else batch
    return dataclasses.replace(batch, **{
        f.name: _cast(getattr(batch, f.name), dtype) for f in dataclasses.fields(batch)
        if not isinstance(getattr(batch, f.name), int)})


def _port_sharded_step(cfg, pp, ps, pb, mesh, dtype=torch.float32):
    params = T.tree_map(lambda t: t.to(dtype), pp)
    state = T.tree_map(lambda t: t.to(dtype), ps)
    ts = T.TrainState.create(params, state, 1e-3)
    step = T.make_train_step(cfg, T.triplet_loss_fn(), mesh)
    ts, loss = step(ts, _cast(pb, dtype), torch.Generator().manual_seed(0))
    grads = {"/".join(k): v.grad.double() for k, v in _leaves((), ts.params)}
    return float(loss), grads, ts


@pytest.mark.parametrize("norm", ["graph", "batch"])
def test_sharded_train_step_matches_jax(norm):
    import optax

    kw = dict(hidden_dim=8, output_dim=8, gin_layers=1, norm_type=norm, dropout=0.0,
              use_residual=True)
    jc, jp, js, (pp, ps) = jax_init(kw, seed=2)
    cfg = GINConfig.create(**kw)
    jb, pb = _stacked(8)
    loss_fn = JT.triplet_loss_fn(margin=1.0)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    jts = JT.TrainState.create(jax.tree_util.tree_map(jnp.asarray, jp),
                               jax.tree_util.tree_map(jnp.asarray, js), opt)
    # JAX's pmean of the per-shard gradients, in shard order
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(jc, p, jts.model_state, b, jax.random.PRNGKey(0))[0]))
    per = [vg(jts.params, jax.tree_util.tree_map(lambda x: x[s], jb))[1] for s in range(8)]
    summed = jax.tree_util.tree_map(lambda *g: sum(g[1:], g[0]), *per)
    jg = {"/".join(k): np.asarray(v, np.float64) / 8 for k, v in _leaves((), summed)}
    # the step donates its state: it runs last
    jts2, jloss = JT.make_train_step(jc, opt, loss_fn, mesh=jmesh())(jts, jb,
                                                                     jax.random.PRNGKey(0))

    loss, grads, ts = _port_sharded_step(cfg, pp, ps, pb, _cpus(8))
    jloss = float(jloss)
    assert abs(loss - jloss) <= 1e-6 * max(1.0, abs(jloss))
    assert grads.keys() == jg.keys()
    ref64 = None
    for k, g in grads.items():
        g, want = g.numpy(), jg[k]
        scale = max(1.0, float(np.abs(want).max()))
        if np.abs(g - want).max() <= TOL * scale:
            continue
        if ref64 is None:
            ref64 = _port_sharded_step(cfg, pp, ps, pb, _cpus(8), torch.float64)[1]
        r = ref64[k].numpy()
        assert np.abs(g - r).max() <= 2 * np.abs(want - r).max() + TOL * scale, k
    if norm == "batch":
        for i, bn in enumerate(ts.model_state["batch_norms"]):
            for key in ("running_mean", "running_var"):
                want = np.asarray(jts2.model_state["batch_norms"][i][key])
                assert not np.array_equal(want, js["batch_norms"][i][key])
                np.testing.assert_allclose(bn[key].numpy(), want, atol=1e-6, rtol=0)


def test_one_shard_mesh_step_is_the_unsharded_step():
    kw = dict(hidden_dim=8, output_dim=8, gin_layers=1, norm_type="batch", dropout=0.0)
    _, _, _, (pp, ps) = jax_init(kw, seed=4)
    cfg = GINConfig.create(**kw)
    _, pb = _stacked(1)
    loss1, grads1, ts1 = _port_sharded_step(cfg, pp, ps, pb, _cpus(1))
    ts0 = T.TrainState.create(pp, ps, 1e-3)
    ts0, loss0 = T.make_train_step(cfg, T.triplet_loss_fn())(
        ts0, D._unstack(pb, 0), torch.Generator().manual_seed(0))
    assert loss1 == float(loss0)
    for (_, a), (_, b) in zip(_leaves((), ts0.params), _leaves((), ts1.params)):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
    for (_, a), (_, b) in zip(_leaves((), ts0.model_state), _leaves((), ts1.model_state)):
        assert torch.equal(a, b)
    ev = T.make_eval_step(cfg, T.triplet_loss_fn(), _cpus(1))(ts1, pb)
    assert torch.equal(ev, T.make_eval_step(cfg, T.triplet_loss_fn())(ts1, D._unstack(pb, 0)))


def test_triplet_cli_data_parallel_matches_jax(eight, tmp_path, monkeypatch, capsys):
    """``tests/test_dp_training_cli.py``'s run at hidden 8, one layer and
    lr 1e-4: 48 training triplets in batches of 4 make one 8-way stack and
    four leftover batches an epoch."""
    rng = np.random.default_rng(7)
    rows = _triplet_rows(rng, 64)
    src = tmp_path / "t.tsv"
    with open(src, "w") as f:
        f.write("anchor_structure\tpositive_structure\tnegative_structure\n")
        for r in zip(*rows.values()):
            f.write("\t".join(r) + "\n")
    args = ["--input_path", str(src), "--model_id", "dp", "--training_mode", "triplet",
            "--hidden_dim", "8", "--gin_layers", "1", "--output_dim", "8", "--batch_size",
            "4", "--num_epochs", "3", "--lr", "1e-4", "--decay_rate", "1.0",
            "--val_fraction", "0.25", "--dropout", "0", "--data-parallel"]
    _, jp, js, (pp, ps) = jax_init(_model_kw(args), seed=42)
    monkeypatch.setattr(cli, "init_params", lambda gen, cfg: (pp, ps))
    _run_both(tmp_path, monkeypatch, args)
    printed = capsys.readouterr().out
    assert printed.count("[train] data parallel over 8 devices") == 2
    assert printed.count("[train] 4/12 batch(es) per epoch run single-device") == 2
    want = _log_losses(tmp_path / "jax" / "output" / "dp" / "train.log")
    got = _log_losses(tmp_path / "port" / "output" / "dp" / "train.log")
    assert [len(x) for x in got] == [len(x) for x in want] == [4, 4]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
