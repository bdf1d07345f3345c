"""The port's ``embed_corpus_windows`` against the JAX package's on the
CPU (the JAX side takes its XLA path there): the same window starts,
embeddings within 1e-5 max abs float32, and the same host grouping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import GINModel as JModel
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import fast_windows as jfw
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.models.checkpoint import params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.pipelines import fast_windows as fw

TOL = 1e-5
FLAGSHIP_SMALL = dict(hidden_dim=128, output_dim=128, gin_layers=2,
                      pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                      norm_type="graph", use_residual=True,
                      normalize_nodes_before_pool=True)


def _corpus(seed=0, n=6, lo=40, hi=130):
    rng = np.random.default_rng(seed)
    out = [random_structure(rng, int(k)) for k in rng.integers(lo, hi, size=n)]
    return out + ["((..[[..))..]].." * 4, "." * 30, "(.)" * 20, "((((....))))" * 5]


def _pair(kw, seed=1):
    jc, pc = JConfig.create(**kw), GINConfig.create(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    h = jc.hidden_dims[-1]
    state = dict(state)
    state["node_mu"] = jnp.asarray(0.1 * rng.normal(size=h).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(h)).astype(np.float32))
    pp, ps = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    return JModel(jc, params, state), GINModel(pc, pp, ps)


CASES = {
    # flagship family (the kernel's gate): keep-paired-neighbors, no mask
    "flagship_keep": (FLAGSHIP_SMALL, 40, True, 0.0, {}),
    # mask_threshold > 0 drops low-complexity windows
    "flagship_mask": (FLAGSHIP_SMALL, 40, True, 0.3, {}),
    "flagship_nokeep": (FLAGSHIP_SMALL, 24, False, 0.1, {}),
    "merged_buckets": (FLAGSHIP_SMALL, 40, True, 0.0, {"max_programs": 1}),
    # forgi edges, add pooling
    "forgi_add": ({**FLAGSHIP_SMALL, "graph_encoding": "forgi",
                   "pooling_type": "global_add_pool",
                   "node_embed_norm": "l2"}, 40, True, 0.0, {}),
    # outside the kernel's gate: norm 'none' and a width of 96 run the
    # plain dense encoder
    "plain_dense_path": ({**FLAGSHIP_SMALL, "hidden_dim": [96, 64], "output_dim": 32,
                          "norm_type": "none"}, 40, True, 0.0, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_embed_corpus_windows_matches_jax(name):
    kw, L, keep, thr, extra = CASES[name]
    jm, pm = _pair(kw)
    structs = _corpus()
    ref = jfw.embed_corpus_windows(jm, structs, L, keep, thr, **extra)
    got = fw.embed_corpus_windows(pm, structs, L, keep, thr, device="cpu", **extra)
    assert len(got) == len(ref)
    n = 0
    for (s0, e0), (s1, e1) in zip(ref, got):
        np.testing.assert_array_equal(s1, s0)
        assert e1.dtype == np.float32 and e1.shape == e0.shape
        np.testing.assert_allclose(e1, e0, atol=TOL, rtol=0)
        n += len(s1)
    assert n > 0


def test_f16_wire_matches_jax():
    """wire='f16' rounds on the device: both sides agree to the f32
    tolerance plus the half's rounding (<= 2^-11 relative, 4.9e-4 at
    values below 1, the l2-normalised range here)."""
    kw = {**FLAGSHIP_SMALL, "pooling_type": "global_mean_pool"}
    jm, pm = _pair(kw)
    structs = _corpus(seed=3)
    ref = jfw.embed_corpus_windows(jm, structs, 40, True, wire="f16")
    got = fw.embed_corpus_windows(pm, structs, 40, True, wire="f16", device="cpu")
    exact = fw.embed_corpus_windows(pm, structs, 40, True, device="cpu")
    for (s0, e0), (s1, e1), (_, ex) in zip(ref, got, exact):
        np.testing.assert_array_equal(s1, s0)
        np.testing.assert_allclose(e1, e0, atol=5e-4, rtol=0)
        np.testing.assert_array_equal(e1, ex.astype(np.float16).astype(np.float32))


def test_grouping_and_packing_match_jax():
    kw = FLAGSHIP_SMALL
    jc, pc = JConfig.create(**kw), GINConfig.create(**kw)
    structs = _corpus(seed=5, n=30, lo=40, hi=400)
    for max_programs in (None, 2):
        jper, jgroups = jfw._prep_corpus_groups(jc, structs, 40, True, 0.1, max_programs)
        per, groups = fw._prep_corpus_groups(pc, structs, 40, True, 0.1, max_programs)
        assert {k: list(v) for k, v in groups.items()} == jgroups
        for a, b in zip(per, jper):
            assert (a is None) == (b is None)
            if a is not None:
                assert a[0] == b[0] and a[3] == b[3]
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[2], b[2])
                np.testing.assert_array_equal(a[4], b[4])
        for n_cap, idxs in groups.items():
            got = fw._pack_group(pc, per, n_cap, idxs)
            ref = jfw._pack_group(jc, jper, n_cap, idxs)
            for a, b in zip(got[:4], ref[:4]):
                np.testing.assert_array_equal(a, b)
            assert got[4] == ref[6]
            assert fw._chunk_for(got[4]) == jfw._chunk_for(ref[6])


def test_dense_forward_gate_matches_jax():
    for change in ({}, {"norm_type": "none"}, {"norm_type": "layer"},
                   {"pooling_type": "set2set"}, {"edge_feature_dim": 5}):
        kw = {**FLAGSHIP_SMALL, **change}
        assert fw._dense_forward_ok(GINConfig.create(**kw)) == \
            jfw._dense_forward_ok(JConfig.create(**kw))


def test_deferred_parts_raise():
    _, pm = _pair(FLAGSHIP_SMALL)
    with pytest.raises(ValueError):
        fw.embed_corpus_windows(pm, ["((...))" * 8], 20, wire="F16", device="cpu")
    # a mesh (ported since) gives the unsharded rows
    mesh = DataMesh(["cpu"] * 3)
    for (s0, e0), (s1, e1) in zip(
            fw.embed_corpus_windows(pm, ["((...))" * 8, "(.)" * 9], 20, device="cpu"),
            fw.embed_corpus_windows(pm, ["((...))" * 8, "(.)" * 9], 20, mesh=mesh)):
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(e0, e1)
    # the compact path (ported since) serves a layer-norm model
    cfg = GINConfig.create(**{**FLAGSHIP_SMALL, "norm_type": "layer"})
    odd = GINModel(cfg, pm.params, pm.state)
    starts, emb = fw.embed_corpus_windows(odd, ["((...))" * 8], 20, device="cpu")[0]
    assert starts.tolist() == list(range(37)) and emb.shape == (37, 128)
    assert np.isfinite(emb).all()
