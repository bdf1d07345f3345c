"""The port's whole-structure graph embeddings (``ginfinity-embed``
without ``--window-size``) against the JAX package on the CPU:
``pool_and_project`` and ``forward_once`` for add and mean pooling, graph
and no norm, nodes normalised before the pool or not; the engine's
``embed_graphs`` in input order across planned batches; and the CLI's
TSV.

Tolerance.  Graph embeddings are held to 1e-5 max abs.  GraphNorm
amplifies last-bit differences of the two float32 sides layer by layer,
and pooled rows are not unit rows (``fc`` follows the pool), so where the
two sides differ beyond 1e-5 both are held to a float64 run of the port:
the port's float32 result must be no farther from it than twice the JAX
result is, and the JAX result within 1e-4 of its largest magnitude.  A
printed embedding adds the 1e-6 by which two values 1e-5 apart may
differ once each is rounded to 6 decimals."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.graphs import batching as jbatching
from ginfinity_tpu.graphs import build as jbuild
from ginfinity_tpu.models import gine as jgine
from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import GINModel as JModel
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import embed as jembed
from ginfinity_tpu.pipelines import engine as jengine
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs import batching, build
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.checkpoint import params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.pipelines import embed, engine

TOL = 1e-5
PRINT_TOL = TOL + 1e-6


def _config(pooling="global_mean_pool", norm="graph", before_pool=True, **kw):
    return dict(hidden_dim=32, output_dim=32, gin_layers=2, pooling_type=pooling,
                node_embed_norm="zscore_l2", norm_type=norm, use_residual=True,
                normalize_nodes_before_pool=before_pool, **kw)


def _jax_model(kw, seed=3):
    jc = JConfig.create(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    h = jc.hidden_dims[-1]
    state = dict(state)
    state["node_mu"] = jnp.asarray(0.1 * rng.normal(size=h).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(h)).astype(np.float32))
    return jc, params, state


def _models(kw, seed=3):
    jc, params, state = _jax_model(kw, seed)
    pp, ps = params_from_jax(GINConfig.create(**kw), jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    return JModel(jc, params, state), GINModel(GINConfig.create(**kw), pp, ps)


def _structures(seed=7, n=9):
    rng = np.random.default_rng(seed)
    out = [random_structure(rng, int(m)) for m in rng.integers(20, 160, size=n)]
    return out + ["((..[[..))..]]..", "....", "(())", "."]


STRUCTURES = _structures()


def _batches(structs, pad=(37, 53, 3)):
    """Both packages' padded batches of the same structures, capacities
    above the real counts (padding nodes, edges and graph slots)."""
    jg = [jbuild.build_standard(s) for s in structs]
    pg = [build.build_standard(s) for s in structs]
    caps = (sum(g.n_nodes for g in pg) + pad[0], sum(g.n_edges for g in pg) + pad[1],
            len(pg) + pad[2])
    return jbatching.batch_graphs(jg, *caps), batching.batch_graphs(pg, *caps)


def _float64(tree):
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float64(v) for v in tree]
    return tree.double()


def _batch64(batch):
    return dataclasses.replace(batch, **{k: getattr(batch, k).double() for k in
                                         ("node_feat", "node_mask", "edge_attr", "edge_mask")})


def _hold(got, ref, x64):
    """``got`` (port) within TOL of ``ref`` (JAX), or, where they differ
    beyond it, no farther than twice ``ref`` from the float64 ``x64``."""
    assert got.shape == ref.shape == x64.shape
    assert np.isfinite(got).all()
    if np.abs(got - ref).max() <= TOL:
        return
    jax_err, port_err = np.abs(ref - x64).max(), np.abs(got - x64).max()
    assert jax_err <= 1e-4 * max(1.0, np.abs(x64).max()), jax_err
    assert port_err <= 2 * jax_err, (port_err, jax_err)


CASES = [(p, n, b) for p in ("global_add_pool", "global_mean_pool")
         for n in ("graph", "none") for b in (True, False)]


@pytest.mark.parametrize("pooling, norm, before_pool", CASES)
def test_pool_and_project_matches_jax(pooling, norm, before_pool):
    """The pool and ``fc`` alone, on the same node states."""
    kw = _config(pooling, norm, before_pool)
    jm, pm = _models(kw)
    jbatch, batch = _batches(STRUCTURES)
    x = np.array(jm.get_node_embeddings(jbatch, apply_norm=before_pool))
    ref = np.asarray(jgine.pool_and_project(jm.config, jm.params, jnp.asarray(x), jbatch))
    got = gine.pool_and_project(pm.config, pm.params, torch.from_numpy(x), batch).numpy()
    x64 = gine.pool_and_project(pm.config, _float64(pm.params), torch.from_numpy(x).double(),
                                _batch64(batch)).numpy()
    assert got.shape == (batch.num_graphs, kw["output_dim"])
    _hold(got, ref, x64)


@pytest.mark.parametrize("pooling, norm, before_pool", CASES)
def test_forward_once_matches_jax(pooling, norm, before_pool):
    kw = _config(pooling, norm, before_pool)
    jm, pm = _models(kw)
    jbatch, batch = _batches(STRUCTURES)
    ref = np.asarray(jm.forward_once(jbatch))
    got = pm.forward_once(batch).numpy()
    x64 = gine.forward_once(pm.config, _float64(pm.params), _float64(pm.state),
                            _batch64(batch)).numpy()
    _hold(got, ref, x64)


@pytest.mark.parametrize("before_pool", [True, False, None])
def test_forward_once_normalize_override(before_pool):
    """``normalize_nodes_before_pool`` given overrides the config's."""
    kw = _config(before_pool=True)
    jm, pm = _models(kw)
    jbatch, batch = _batches(STRUCTURES[:6])
    ref, _ = jgine.forward_once(jm.config, jm.params, jm.state, jbatch,
                                normalize_nodes_before_pool=before_pool)
    got = gine.forward_once(pm.config, pm.params, pm.state, batch,
                            normalize_nodes_before_pool=before_pool).numpy()
    x64 = gine.forward_once(pm.config, _float64(pm.params), _float64(pm.state),
                            _batch64(batch), normalize_nodes_before_pool=before_pool).numpy()
    _hold(got, np.asarray(ref), x64)


def test_set2set_raises_naming_item_2():
    """Set2Set, which raised naming ROADMAP item 2 until it was ported:
    ``init_params`` gives the LSTM and a ``2 x last``-wide ``fc``, and
    ``pool_and_project`` equals the JAX package's on the same node states
    (padding nodes and graph slots included)."""
    params, _ = gine.init_params(torch.Generator().manual_seed(0),
                                 GINConfig.create(**_config("set2set")))
    assert params["set2set"]["w_ih"].shape == (128, 64)
    assert params["fc"]["kernel"].shape == (64, 32)
    jm, pm = _models(_config("set2set"))
    jbatch, batch = _batches(STRUCTURES)
    x = np.array(jm.get_node_embeddings(jbatch))
    ref = np.asarray(jgine.pool_and_project(jm.config, jm.params, jnp.asarray(x), jbatch))
    got = gine.pool_and_project(pm.config, pm.params, torch.from_numpy(x), batch).numpy()
    x64 = gine.pool_and_project(pm.config, _float64(pm.params), torch.from_numpy(x).double(),
                                _batch64(batch)).numpy()
    _hold(got, ref, x64)


@pytest.mark.parametrize("batch_nodes", [8192, 150, 40])
def test_embed_graphs_in_input_order(batch_nodes):
    """Several planned batches (a small node budget): the rows come back
    in input order, equal to the JAX engine's and to each graph embedded
    alone."""
    jm, pm = _models(_config())
    structs = STRUCTURES + _structures(seed=8, n=6)
    graphs = engine.preprocess_structures(structs).graphs
    jgraphs = jengine.preprocess_structures(structs).graphs
    eng = engine.InferenceEngine(pm, max_nodes_per_batch=batch_nodes, device="cpu")
    plan = eng._plan(graphs)
    assert len(plan) >= {8192: 1, 150: 5, 40: 10}[batch_nodes]
    assert sorted(sum(plan, [])) != sum(plan, [])  # the plan reorders graphs
    got = eng.embed_graphs(graphs)
    ref = jengine.InferenceEngine(jm, max_nodes_per_batch=batch_nodes).embed_graphs(jgraphs)
    assert got.dtype == np.float32 and got.shape == (len(structs), 32)
    alone = np.concatenate([pm.forward_once(batching.batch_graphs([g])).numpy()
                            for g in graphs])
    np.testing.assert_allclose(got, alone, atol=TOL, rtol=0)
    whole = batching.batch_graphs(graphs)
    x64 = gine.forward_once(pm.config, _float64(pm.params), _float64(pm.state),
                            _batch64(whole)).numpy()
    _hold(got, ref, x64)


def test_embed_graphs_of_nothing():
    _, pm = _models(_config())
    out = engine.InferenceEngine(pm, device="cpu").embed_graphs([])
    assert out.shape == (0, 32) and out.dtype == np.float32


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_cli")
    kw = _config()
    jc, params, state = _jax_model(kw, seed=4)
    model = str(d / "model.pth")
    export_torch_checkpoint(model, jc, params, state)
    rng = np.random.default_rng(4)
    rows = []
    for i, n in enumerate(rng.integers(30, 140, size=10)):
        s = random_structure(rng, int(n))
        seq = "".join(rng.choice(list("ACGU"), size=len(s)))
        rows.append((f"r{i}", s, seq, f"fam {i % 3}" if i % 4 else "", len(s), str(i * 0.5)))
    rows.append(("bad", "((..", "ACGU", "fam x", 4, "9"))      # invalid: logged, skipped
    rows.append(("pk", "((..[[..))..]]..", "A" * 16, "fam y", 16, "1e3"))
    rows.append(("dot", ".", "A", "", 1, "2"))
    src = d / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure", "sequence", "family", "seq_len", "score"])
        w.writerows(rows)
    return d, str(src), model


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _run_both(src, model, extra, tmp_path):
    args = ["--input", src, "--id-column", "rid", "--model-path", model, "--quiet", *extra]
    jembed.main([*args, "--output", str(tmp_path / "jax.tsv")])
    embed.main([*args, "--output", str(tmp_path / "port.tsv"), "--device", "cpu"])
    return _read(tmp_path / "jax.tsv"), _read(tmp_path / "port.tsv")


def _float64_cli(model_path, src, ids, extra):
    """The port's float64 embeddings of the CLI's rows ``ids``."""
    from ginfinity_tpu_torch.models.checkpoint import load_checkpoint
    from ginfinity_tpu_torch.utils.io import read_table

    cfg, params, state, _ = load_checkpoint(model_path)
    table = read_table(src)
    by_id = {r["rid"]: r for r in table.rows}
    seq_w = float(extra[extra.index("--seq-weight") + 1]) if "--seq-weight" in extra else 0.0
    graphs = engine.preprocess_structures(
        [by_id[i]["secondary_structure"] for i in ids],
        [by_id[i]["sequence"] for i in ids], seq_weight=min(1.0, max(0.0, seq_w)),
        graph_encoding=cfg.graph_encoding, feature_dim=cfg.node_feature_dim).graphs
    batch = batching.batch_graphs(graphs)
    model = GINModel(cfg, params, state)
    return gine.forward_once(cfg, _float64(model.params), _float64(model.state),
                             _batch64(batch)).numpy()


def _check_tsv(ref, got, model, src, extra):
    assert got[0] == ref[0]
    assert len(got) == len(ref) > 1
    col = ref[0].index("embedding_vector")
    for g, r in zip(got[1:], ref[1:]):
        assert g[:col] + g[col + 1:] == r[:col] + r[col + 1:]
    gv = np.array([g[col].split(",") for g in got[1:]], np.float64)
    rv = np.array([r[col].split(",") for r in ref[1:]], np.float64)
    assert gv.shape == (len(got) - 1, 32)
    if np.abs(gv - rv).max() > PRINT_TOL:
        x64 = _float64_cli(model, src, [g[0] for g in got[1:]], extra)
        jax_err, port_err = np.abs(rv - x64).max(), np.abs(gv - x64).max()
        assert port_err <= 2 * jax_err + 1e-6, (port_err, jax_err)


@pytest.mark.parametrize("extra", [
    [],
    ["--batch-nodes", "120"],
    ["--keep-cols", "family"],
    ["--keep-cols", "score,rid"],
    ["--seq-weight", "0.4"],
    ["--seq-weight", "3"],  # clamped to 1
    ["--graph-encoding", "standard", "--seq-weight", "-1"],  # clamped to 0
])
def test_cli_tsv_matches_jax(cli_inputs, extra, tmp_path):
    _, src, model = cli_inputs
    ref, got = _run_both(src, model, extra, tmp_path)
    _check_tsv(ref, got, model, src, extra)
    log = (tmp_path / "port.log").read_text()
    assert "skipped_invalid_dot_bracket: ID bad" in log
    assert "num_embeddings: 12" in log


def test_cli_columns_types_and_seq_weight(cli_inputs, tmp_path):
    """Column order (id, embedding, the rest sorted), pandas' types
    (``1e3`` -> ``1000.0``, ``0`` -> ``0.0`` in a float column), ``NaN``
    for a missing cell, ``seq_len`` kept; and ``--seq-weight`` changes the
    embeddings only of rows with a sequence."""
    _, src, model = cli_inputs
    _, got = _run_both(src, model, [], tmp_path)
    assert got[0] == ["rid", "embedding_vector", "family", "score", "seq_len", "sequence"]
    rows = {g[0]: dict(zip(got[0], g)) for g in got[1:]}
    assert [rows["pk"][c] for c in ("score", "seq_len", "family")] == ["1000.0", "16", "fam y"]
    assert [rows["r0"][c] for c in ("score", "family")] == ["0.0", "NaN"]
    assert "bad" not in rows
    _, weighted = _run_both(src, model, ["--seq-weight", "0.4"], tmp_path)
    wrows = {g[0]: g[1] for g in weighted[1:]}
    assert all(wrows[k] != rows[k]["embedding_vector"] for k in rows)


def test_cli_header_only_when_nothing_is_valid(cli_inputs, tmp_path):
    d, _, model = cli_inputs
    src = tmp_path / "bad.csv"
    src.write_text("rid,secondary_structure,seq_len,note\na,((..,4,x\nb,)(,2,y\n")
    ref, got = _run_both(str(src), model, [], tmp_path)
    assert got == ref == [["rid", "seq_len", "seq_len", "note", "embedding_vector"]]
    log = (tmp_path / "port.log").read_text()
    assert "num_embeddings: 0" in log and "skipped_invalid_dot_bracket: ID a" in log


def test_cli_forgi_raises_naming_item_1(cli_inputs, tmp_path):
    """A forgi checkpoint, which raised naming ROADMAP item 1 until the
    forgi encoding was ported: its graphs (bases and element meta-nodes)
    embed as the JAX CLI embeds them, with the encoding taken from the
    checkpoint or given by ``--graph-encoding``."""
    _, src, _ = cli_inputs
    jc, params, state = _jax_model(_config(graph_encoding="forgi"), seed=4)
    model = str(tmp_path / "forgi.pth")
    export_torch_checkpoint(model, jc, params, state)
    for extra in ([], ["--graph-encoding", "forgi"]):
        ref, got = _run_both(src, model, extra, tmp_path)
        _check_tsv(ref, got, model, src, extra)
