"""The port's forgi encoding against ``ginfinity_tpu.graphs`` on the CPU:
the element decomposition, the element connections and the whole forgi
graph array-equal (tolerance 0) on seeded structures, pseudoknots
included, and on the edge cases of ``tests/conftest.py``; the goldens
and property checks of ``tests/test_forgi_golden.py`` on the port's
decomposition; and a forgi model's ``forward_once`` and base-only node
embeddings within 1e-5 of the JAX package's, where a float64 run of the
port breaks the ties that GraphNorm's amplification of float32 order
leaves (the rule of ``tests/test_torch_graph_embed.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_forgi_golden import GOLDEN, element_string
from test_forgi_golden import random_structure as stack_structure
from test_torch_graph_embed import _batch64, _float64, _hold
from torch_oracle import run_oracle

from ginfinity_tpu.graphs import batching as jbatching
from ginfinity_tpu.graphs import build as jbuild
from ginfinity_tpu.graphs import forgi_elements as jforgi
from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import GINModel as JModel
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import engine as jengine
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs import batching, build, dotbracket, forgi_elements
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.checkpoint import load_checkpoint, params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.pipelines import engine

TOL = 1e-5
# the in-line extras of tests/conftest.py::sample_structures
EXTRAS = [("ACGU", "...."), ("ACGUACGUAC", "((......))"), ("GGGAAACCCU", "(((...)))."),
          ("ACGUACGUACGUACGU", "((..[[..))..]].."), ("AC", "()"), ("ACGUACGU", "(.(...))")]
EDGE = ["", ".", "()", "([)(])", "((..AA..))..aa..", "<<..{{..>>..}}..((..))",
        "((((...))((...))))", "((...))..((...))"]


def _seeded(seed=11, n=40):
    """Nested structures from the MSA generator and stack-simulated ones,
    a quarter of those pseudoknotted."""
    rng = np.random.default_rng(seed)
    out = [random_structure(rng, int(k)) for k in rng.integers(10, 220, size=n // 2)]
    out += [stack_structure(rng, int(rng.integers(1, 150)), pseudoknot=t % 4 == 0)
            for t in range(n // 2)]
    return out


STRUCTURES = [s for _, s in EXTRAS] + EDGE + _seeded()
CHUNKS = [STRUCTURES[k::6] for k in range(6)]


@pytest.mark.parametrize("structure, expected, counts", GOLDEN)
def test_golden_element_strings(structure, expected, counts):
    """The goldens of ``tests/test_forgi_golden.py`` on the port."""
    els = forgi_elements.decompose_elements(dotbracket.pair_table(structure))
    letters = [None] * len(structure)
    kinds: dict[str, int] = {}
    for el in els:
        kinds[el.kind] = kinds.get(el.kind, 0) + 1
        for pos in el.members:
            assert letters[pos] is None
            letters[pos] = {"stem": "s", "hairpin": "h", "internal": "i", "multiloop": "m",
                            "five_prime": "f", "three_prime": "t"}[el.kind]
    assert "".join(letters) == expected == element_string(structure)
    assert kinds == counts


@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_decomposition_equals_jax(chunk):
    """Nested pairs, elements (kind, members, bordering stems) and element
    connections equal the JAX package's, and each base lies in exactly
    one element."""
    for s in CHUNKS[chunk]:
        pt = dotbracket.pair_table(s, strict=False)
        if pt is None:
            continue
        np.testing.assert_array_equal(forgi_elements._nested_pairs(pt),
                                      jforgi._nested_pairs(pt))
        got, ref = forgi_elements.decompose_elements(pt), jforgi.decompose_elements(pt)
        assert [(e.kind, e.members, e.connected_stems) for e in got] == \
            [(e.kind, e.members, e.connected_stems) for e in ref], s
        assert forgi_elements.element_connections(got) == jforgi.element_connections(ref)
        seen = np.zeros(len(s), np.int64)
        for el in got:
            np.add.at(seen, el.members, 1)
        assert (seen == 1).all(), s


@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_nested_subset_is_inclusion_maximal(chunk):
    """A pair the decomposition drops crosses a pair it keeps."""
    for s in CHUNKS[chunk]:
        pt = dotbracket.pair_table(s, strict=False)
        if pt is None:
            continue
        nested = forgi_elements._nested_pairs(pt)
        kept = [(i, int(nested[i])) for i in range(len(s)) if nested[i] > i]
        for a in range(len(s)):
            b = int(pt[a])
            if b > a and nested[a] != b:
                assert any(c < a < d < b or a < c < b < d for c, d in kept), (s, a, b)


def test_pseudoknot_regression_keeps_noncrossing_pair():
    nested = forgi_elements._nested_pairs(np.array([2, 4, 0, 5, 1, 3], np.int32))
    assert nested.tolist() == [2, -1, 0, 5, -1, 3]


@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
@pytest.mark.parametrize("seq_weight, feature_dim", [(0.0, None), (0.4, None), (0.0, 12),
                                                     (0.0, 20)])
def test_build_forgi_equals_jax(chunk, seq_weight, feature_dim):
    for s in CHUNKS[chunk]:
        if dotbracket.pair_table(s, strict=False) is None:
            continue
        seq = "ACGU" * (len(s) // 4 + 1)
        ref = jbuild.build_graph_arrays(s, seq, seq_weight, "forgi", feature_dim)
        got = build.build_graph_arrays(s, seq, seq_weight, "forgi", feature_dim)
        for f in ("node_feat", "edge_src", "edge_dst", "edge_attr"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (s, f)
            np.testing.assert_array_equal(a, b)
        assert (got.n_nodes, got.n_base_nodes) == (ref.n_nodes, ref.n_base_nodes)


def test_batches_of_forgi_graphs_equal_jax():
    """Padded batches of forgi graphs, meta-nodes included: the same
    tensors, ``base_mask`` marking the bases alone."""
    structs = [s for s in STRUCTURES[:20] if dotbracket.pair_table(s, strict=False) is not None]
    pg = [build.build_forgi(s) for s in structs]
    jg = [jbuild.build_forgi(s) for s in structs]
    caps = (sum(g.n_nodes for g in pg) + 9, sum(g.n_edges for g in pg) + 5, len(pg) + 2)
    got, ref = batching.batch_graphs(pg, *caps), jbatching.batch_graphs(jg, *caps)
    for f in ("node_feat", "node_graph", "node_mask", "base_mask", "edge_src", "edge_dst",
              "edge_attr", "edge_mask", "n_nodes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    assert got.base_mask.sum().item() == sum(g.n_base_nodes for g in pg)


# ---------------------------------------------------------------- the model

FORGI = dict(hidden_dim=32, output_dim=32, gin_layers=2, graph_encoding="forgi",
             pooling_type="global_mean_pool", node_embed_norm="zscore_l2", norm_type="graph",
             use_residual=True, normalize_nodes_before_pool=True)
MODEL_STRUCTURES = [s for s in STRUCTURES if dotbracket.pair_table(s, strict=False) is not None
                    and len(s) > 0][:18]


def _models(seed=5):
    jc = JConfig.create(**FORGI)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    state = dict(state)
    state["node_mu"] = jnp.asarray(0.1 * rng.normal(size=32).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(32)).astype(np.float32))
    pp, ps = params_from_jax(GINConfig.create(**FORGI), jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    return (jc, params, state), JModel(jc, params, state), GINModel(GINConfig.create(**FORGI),
                                                                     pp, ps)


def _forgi_batches(structs, pad=(11, 7, 2)):
    jg = [jbuild.build_forgi(s) for s in structs]
    pg = [build.build_forgi(s) for s in structs]
    caps = (sum(g.n_nodes for g in pg) + pad[0], sum(g.n_edges for g in pg) + pad[1],
            len(pg) + pad[2])
    return jbatching.batch_graphs(jg, *caps), batching.batch_graphs(pg, *caps), pg


def test_forgi_forward_once_matches_jax_and_oracle(tmp_path):
    (jc, jp, js), jm, pm = _models()
    jb, pb, pg = _forgi_batches(MODEL_STRUCTURES)
    ref = np.asarray(jm.forward_once(jb))
    got = pm.forward_once(pb).numpy()
    x64 = gine.forward_once(pm.config, _float64(pm.params), _float64(pm.state),
                            _batch64(pb)).numpy()
    _hold(got, ref, x64)
    ckpt = str(tmp_path / "forgi.pth")
    export_torch_checkpoint(ckpt, jc, jp, js)
    oracle = run_oracle(ckpt, [g.node_feat for g in pg], [g.edge_src for g in pg],
                        [g.edge_dst for g in pg], [g.edge_attr for g in pg])
    _hold(got[: len(pg)], oracle, x64[: len(pg)])
    cfg, params, state, _ = load_checkpoint(ckpt)
    np.testing.assert_array_equal(GINModel(cfg, params, state).forward_once(pb).numpy(), got)


def test_forgi_base_node_embeddings_match_jax():
    """Base-only node embeddings (meta-nodes dropped): one row per base,
    within 1e-5 of the JAX engine's, or no farther than it from float64."""
    _, jm, pm = _models()
    structs = MODEL_STRUCTURES
    pre = engine.preprocess_structures(structs, graph_encoding="forgi", feature_dim=16)
    jpre = jengine.preprocess_structures(structs, graph_encoding="forgi", feature_dim=16)
    got = engine.InferenceEngine(pm, max_nodes_per_batch=300, device="cpu").node_embeddings(
        pre.graphs, base_only=True)
    ref = jengine.InferenceEngine(jm, max_nodes_per_batch=300).node_embeddings(
        jpre.graphs, base_only=True)
    whole = batching.batch_graphs(pre.graphs)
    x64 = gine.get_node_embeddings(pm.config, _float64(pm.params), _float64(pm.state),
                                   _batch64(whole)).numpy()
    off = 0
    for s, g, a, b in zip(structs, pre.graphs, got, ref):
        assert a.shape == np.asarray(b).shape == (len(s), 32)
        _hold(a, np.asarray(b), x64[off: off + len(s)])
        off += g.n_nodes
    alls = engine.InferenceEngine(pm, device="cpu").node_embeddings(pre.graphs, base_only=False)
    assert [m.shape[0] for m in alls] == [g.n_nodes for g in pre.graphs]
    for a, b in zip(got, alls):
        np.testing.assert_allclose(a, b[: a.shape[0]], atol=TOL, rtol=0)
    assert torch.isfinite(torch.from_numpy(np.concatenate(got))).all()
