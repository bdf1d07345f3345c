"""The port's node-embedding path against the JAX package on the CPU:
standard graphs array-equal (tolerance 0) on seeded structures,
pseudoknots and edge cases; padded batches and batch plans equal;
``get_node_embeddings`` within 1e-5 max abs float32; and the
``ginfinity-generate-node-embeddings`` TSV with the same columns and
rows, its matrices within 1e-5 once parsed.

Tolerances.  Both sides compute the same float32 products and segment
sums, summed in another order (MKL against Eigen).  GraphNorm divides
each feature by its per-graph standard deviation, which amplifies those
last-bit differences layer by layer: measured against a float64 run of
the port, the port and JAX are equally far off (4.7e-4 and 4.1e-4 at
2 layers, raw values up to 13).  So the node-normalised output (unit
rows, what every pipeline writes) is held to 1e-5 abs, the raw
node states to 1e-5 of their largest magnitude, and a printed matrix to
1e-5 plus the 1e-6 by which two values 1e-5 apart may differ once each
is rounded to 6 decimals."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.graphs import batching as jbatching
from ginfinity_tpu.graphs import build as jbuild
from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import GINModel as JModel
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import engine as jengine
from ginfinity_tpu.pipelines import node_embed as jnode_embed
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs import batching, build
from ginfinity_tpu_torch.models.checkpoint import params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.pipelines import engine, node_embed

TOL = 1e-5
PRINT_TOL = TOL + 1e-6
# the edge cases of tests/conftest.py::sample_structures, with sequences
EDGE_CASES = [
    ("ACGU", "...."),
    ("ACGUACGUAC", "((......))"),
    ("GGGAAACCCU", "(((...)))."),
    ("ACGUACGUACGUACGU", "((..[[..))..]].."),
    ("AC", "()"),
    ("ACGUACGU", "(.(...))"),
]
CONFIGS = {
    "graphnorm_zscore_l2_2x128": dict(hidden_dim=128, output_dim=128, gin_layers=2,
                                      pooling_type="global_mean_pool",
                                      node_embed_norm="zscore_l2", norm_type="graph",
                                      use_residual=True, normalize_nodes_before_pool=True),
    "nonuniform_64_128_to_32": dict(hidden_dim=[64, 128], output_dim=32, gin_layers=2,
                                    node_embed_norm="zscore_l2", norm_type="graph",
                                    use_residual=True),
    "norm_none_l2": dict(hidden_dim=64, output_dim=32, gin_layers=2,
                         node_embed_norm="l2", norm_type="none"),
}


def _structures(seed=30):
    rng = np.random.default_rng(seed)
    out = [random_structure(rng, int(n)) for n in rng.integers(20, 200, size=6)]
    for k, s in enumerate(out[:3]):  # overlay a pseudoknot helix
        chars = list(s)
        free = [i for i, c in enumerate(chars) if c == "."]
        if len(free) >= 4:
            chars[free[0]], chars[free[-1]] = "[{A"[k], "]}a"[k]
        out.append("".join(chars))
    return out + ["((..AA..))..aa..", "<<..{{..>>..}}..((..))", ".", "(())"]


STRUCTURES = [s for _, s in EDGE_CASES] + _structures()


def _graph_fields(g):
    return (g.node_feat, g.edge_src, g.edge_dst, g.edge_attr, g.n_nodes, g.n_base_nodes)


@pytest.mark.parametrize("k", range(len(STRUCTURES)))
@pytest.mark.parametrize("seq_weight, feature_dim", [(0.0, None), (0.3, None), (0.0, 3)])
def test_build_graph_arrays_equal(k, seq_weight, feature_dim):
    s = STRUCTURES[k]
    seq = "ACGU" * (len(s) // 4 + 1) if seq_weight else None
    ref = jbuild.build_graph_arrays(s, seq, seq_weight, "standard", feature_dim)
    got = build.build_graph_arrays(s, seq, seq_weight, "standard", feature_dim)
    for a, b in zip(_graph_fields(got), _graph_fields(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert got.n_edges == ref.n_edges


def test_build_unported_and_invalid():
    """The forgi encoding (ported since) equals the JAX package's; an
    unknown encoding and an invalid structure still raise."""
    ref = jbuild.build_graph_arrays("((..))", graph_encoding="forgi")
    got = build.build_graph_arrays("((..))", graph_encoding="forgi")
    for a, b in zip(_graph_fields(got), _graph_fields(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        build.build_graph_arrays("((..))", graph_encoding="bogus")
    with pytest.raises(ValueError):
        build.build_standard("((..")


@pytest.mark.parametrize("caps", [None, (1024, 2048, 32)])
def test_batch_graphs_equal(caps):
    structs = STRUCTURES[:12]
    jg = [jbuild.build_standard(s) for s in structs]
    pg = [build.build_standard(s) for s in structs]
    ref = jbatching.batch_graphs(jg, *(caps or ()))
    got = batching.batch_graphs(pg, *(caps or ()))
    assert got.num_graphs == ref.num_graphs
    for name in ("node_feat", "node_graph", "node_mask", "base_mask", "edge_src",
                 "edge_dst", "edge_attr", "edge_mask", "n_nodes"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    assert batching.bucket_sizes(300, 700) == jbatching.bucket_sizes(300, 700)


@pytest.mark.parametrize("limits", [(8192, 512), (200, 512), (400, 3), (1, 1)])
def test_plan_batches_equal(limits):
    graphs = [build.build_standard(s) for s in STRUCTURES]
    jgraphs = [jbuild.build_standard(s) for s in STRUCTURES]
    assert batching.plan_batches(graphs, *limits) == jbatching.plan_batches(jgraphs, *limits)


def _models(kw, seed=3, norm_noise=0.0):
    jc, pc = JConfig.create(**kw), GINConfig.create(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    h = jc.hidden_dims[-1]
    state = dict(state)
    state["node_mu"] = jnp.asarray(0.1 * rng.normal(size=h).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(h)).astype(np.float32))
    # GraphNorm weight, bias and mean_scale away from their 1 / 0 / 1 start
    norms = []
    for p in params["norms"]:
        norms.append({k: jnp.asarray(np.asarray(v) + norm_noise * rng.normal(size=v.shape)
                                     .astype(np.float32)) for k, v in p.items()})
    params = {**params, "norms": norms}
    pp, ps = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    return (jc, params, state), GINModel(pc, pp, ps)


def _padded_batches(structs):
    """The same structures batched by both packages, with capacities above
    the real counts: masked padding edges point at node 0."""
    jg = [jbuild.build_standard(s) for s in structs]
    pg = [build.build_standard(s) for s in structs]
    n = sum(g.n_nodes for g in pg)
    e = sum(g.n_edges for g in pg)
    caps = (n + 37, e + 53, len(pg) + 2)
    return jbatching.batch_graphs(jg, *caps), batching.batch_graphs(pg, *caps), n


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("apply_norm", [True, False])
def test_get_node_embeddings_matches_jax(name, apply_norm):
    (jc, jp, js), model = _models(CONFIGS[name])
    jbatch, batch, n = _padded_batches(STRUCTURES[4:14])
    ref = np.asarray(JModel(jc, jp, js).get_node_embeddings(jbatch, apply_norm=apply_norm))
    got = model.get_node_embeddings(batch, apply_norm=apply_norm).numpy()
    assert got.shape == ref.shape
    tol = TOL if apply_norm else TOL * np.abs(ref[:n]).max()
    np.testing.assert_allclose(got[:n], ref[:n], atol=tol, rtol=0)
    assert np.isfinite(got).all()


def _float64(tree):
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float64(v) for v in tree]
    return tree.double()


@pytest.mark.parametrize("name", ["graphnorm_zscore_l2_2x128", "nonuniform_64_128_to_32"])
def test_graphnorm_parameters_against_float64(name):
    """GraphNorm weight, bias and mean_scale away from 1 / 0 / 1 make the
    stack worse conditioned, so the two float32 sides drift apart by more
    than 1e-5.  Held instead to a float64 run of the port: the JAX result
    must agree with it to float32 accuracy (a wrong term would be off by
    far more), and the port's float32 result must be no farther from it
    than twice the JAX result is."""
    import dataclasses

    from ginfinity_tpu_torch.models.gine import get_node_embeddings

    (jc, jp, js), model = _models(CONFIGS[name], norm_noise=0.2)
    jbatch, batch, n = _padded_batches(STRUCTURES[4:14])
    ref = np.asarray(JModel(jc, jp, js).get_node_embeddings(jbatch, apply_norm=False))[:n]
    got = model.get_node_embeddings(batch, apply_norm=False).numpy()[:n]
    b64 = dataclasses.replace(batch, **{k: getattr(batch, k).double() for k in
                                        ("node_feat", "node_mask", "edge_attr", "edge_mask")})
    x64 = get_node_embeddings(model.config, _float64(model.params), _float64(model.state),
                              b64, apply_norm=False).numpy()[:n]
    scale = np.abs(x64).max()
    jax_err, port_err = np.abs(ref - x64).max(), np.abs(got - x64).max()
    assert jax_err <= 1e-4 * scale
    assert port_err <= 2 * jax_err


def test_encode_nodes_unported_modes():
    """Every mode is ported now: training (ROADMAP item 10, once refused
    here) is ``encode_nodes_train``, which at dropout 0 with no batch norm
    gives the inference rows bit for bit, and ``encode_nodes`` takes no
    ``train`` flag; layer norm runs in inference."""
    from ginfinity_tpu_torch.models.gine import encode_nodes, encode_nodes_train

    (_, _, _), model = _models(CONFIGS["norm_none_l2"])
    batch = batching.batch_graphs([build.build_standard("((..))")])
    with pytest.raises(TypeError, match="train"):
        encode_nodes(model.config, model.params, model.state, batch, train=True)
    cfg = dataclasses.replace(model.config, dropout=0.0)
    rows, _ = encode_nodes_train(cfg, model.params, model.state, batch)
    assert torch.equal(rows, encode_nodes(cfg, model.params, model.state, batch))
    cfg = GINConfig.create(**{**CONFIGS["norm_none_l2"], "norm_type": "layer"})
    params = {**model.params, "norms": [{"weight": torch.ones(64), "bias": torch.zeros(64)}] * 2}
    out = encode_nodes(cfg, params, model.state, batch)
    assert out.shape == (batch.num_nodes_padded, 64) and torch.isfinite(out).all()


@pytest.mark.parametrize("batch_nodes", [8192, 150])
def test_engine_node_embeddings_match_jax(batch_nodes):
    (jc, jp, js), model = _models(CONFIGS["graphnorm_zscore_l2_2x128"])
    structs = STRUCTURES + [None, "((..", 7]
    pre = engine.preprocess_structures(structs)
    jpre = jengine.preprocess_structures(structs)
    assert pre.kept_indices == jpre.kept_indices and pre.skipped == jpre.skipped
    ref = jengine.InferenceEngine(JModel(jc, jp, js), max_nodes_per_batch=batch_nodes) \
        .node_embeddings(jpre.graphs)
    got = engine.InferenceEngine(model, max_nodes_per_batch=batch_nodes, device="cpu") \
        .node_embeddings(pre.graphs)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=TOL, rtol=0)


def test_adapt_graphs_to_model_matches_jax():
    graphs = [build.build_standard(s) for s in STRUCTURES[:5]]
    jgraphs = [jbuild.build_standard(s) for s in STRUCTURES[:5]]
    for kw in (dict(hidden_dim=8, output_dim=8, graph_encoding="forgi"),
               dict(hidden_dim=8, output_dim=8, node_feature_dim=3),
               dict(hidden_dim=8, output_dim=8, node_feature_dim=6)):
        got = engine.adapt_graphs_to_model(graphs, GINConfig.create(**kw))
        ref = jengine.adapt_graphs_to_model(jgraphs, JConfig.create(**kw))
        for a, b in zip(got, ref):
            for x, y in zip(_graph_fields(a), _graph_fields(b)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_serialize_matrix_byte_identical():
    rng = np.random.default_rng(0)
    m = np.concatenate([rng.normal(size=(30, 8)).astype(np.float32) * 10,
                        np.float32([[0.0, -0.0, 1e-7, -5e-7, 0.5e-6, 123456.78, 1.0, -2.5]])])
    s = node_embed.serialize_matrix(m)
    assert s == jnode_embed.serialize_matrix(m)
    np.testing.assert_array_equal(node_embed.parse_matrix(s), jnode_embed.parse_matrix(s))
    with pytest.raises(ValueError):
        node_embed.parse_matrix("[1.0, 2.0]")


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("node_embed_cli")
    (jc, jp, js), _ = _models(CONFIGS["graphnorm_zscore_l2_2x128"], seed=5)
    model = str(d / "model.pth")
    export_torch_checkpoint(model, jc, jp, js)
    rng = np.random.default_rng(5)
    rows = [(f"r{i}", random_structure(rng, int(n)), f"fam {i % 3}", "x" if i % 2 else "")
            for i, n in enumerate(rng.integers(30, 90, size=5))]
    rows.append(("bad", "((..", "fam x", "y"))  # invalid: logged, skipped
    rows.append(("pk", "((..[[..))..]]..", "fam y", "z"))
    src = d / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure", "zeta", "family"])
        w.writerows(rows)
    return str(src), model


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


@pytest.mark.parametrize("extra", [[], ["--keep-cols", "family"], ["--batch-nodes", "100"]])
def test_node_embed_cli_matches_jax(cli_inputs, extra, tmp_path):
    src, model = cli_inputs
    args = ["--input", src, "--id-column", "rid", "--model-path", model, "--quiet", *extra]
    jnode_embed.main([*args, "--output", str(tmp_path / "jax.tsv")])
    node_embed.main([*args, "--output", str(tmp_path / "port.tsv"), "--device", "cpu"])
    ref, got = _read(tmp_path / "jax.tsv"), _read(tmp_path / "port.tsv")
    assert got[0] == ref[0] and len(got) == len(ref) == 7
    col = ref[0].index("node_embeddings")
    for g, r in zip(got[1:], ref[1:]):
        assert g[:col] + g[col + 1:] == r[:col] + r[col + 1:]
        np.testing.assert_allclose(node_embed.parse_matrix(g[col]),
                                   jnode_embed.parse_matrix(r[col]), atol=PRINT_TOL, rtol=0)
    assert "skipped_invalid_dot_bracket: ID bad" in (tmp_path / "port.log").read_text()


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def _jax_node_embed_parser():
    """The JAX CLI builds its parser inside ``main``: capture it."""
    import argparse

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jnode_embed.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["p"]


def test_node_embed_parser_is_flag_superset():
    ref, got = _options(_jax_node_embed_parser()), _options(node_embed.build_parser())
    assert set(ref) <= set(got)
    for opt, a in ref.items():
        b = got[opt]
        assert (b.default, b.required, b.choices, b.type, b.nargs, b.const, b.dest) == \
            (a.default, a.required, a.choices, a.type, a.nargs, a.const, a.dest), opt


@pytest.mark.parametrize("extra, says", [
    # --graph-pt mode (ported since) still needs a checkpoint
    pytest.param(["--graph-pt", "g.npz", "--meta-tsv", "m.tsv"], "--model-path is required",
                 id="extra0-not ported yet (ROADMAP queue 1, item 6)"),
    (["--model-path", "m.pth", "--graph-pt", "g.npz"], "must be given together"),
    ([], "--model-path is required"),
])
def test_node_embed_cli_exits_cleanly(cli_inputs, extra, says, tmp_path):
    src, _ = cli_inputs
    with pytest.raises(SystemExit) as e:
        node_embed.main(["--input", src, "--id-column", "rid", "--device", "cpu",
                         "--output", str(tmp_path / "o.tsv"), *extra])
    assert says in str(e.value)


def test_node_embeddings_on_the_card_unasked_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model = _models(CONFIGS["norm_none_l2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.InferenceEngine(model)
