"""The compact window path of the port (configs outside the dense window
forward: layer, instance and batch norm, Set2Set) against the JAX
package's ``embed_corpus_windows`` on the CPU, and against the port's
own two-step flow (windows CLI, then ``embed --graph-pt``).

Tolerance 1e-4 max abs float32: the bar the JAX package holds its own
fused window path to against the file-based flow
(``tests/test_fast_windows.py``); the two sides build the same window
graphs with their nodes in another order, so segment sums differ in
order.  Window starts are equal exactly."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import GINModel as JModel
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import embed as jembed
from ginfinity_tpu.pipelines import fast_windows as jfw
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.models.checkpoint import params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.pipelines import embed, windows
from ginfinity_tpu_torch.pipelines import fast_windows as fw

TOL = 1e-4
BASE = dict(hidden_dim=32, output_dim=24, gin_layers=2, node_embed_norm="zscore_l2",
            use_residual=True)
CASES = {
    "layer_mean": dict(norm_type="layer", pooling_type="global_mean_pool",
                       normalize_nodes_before_pool=True),
    "graph_set2set": dict(norm_type="graph", pooling_type="set2set"),
    "batch_add": dict(norm_type="batch", pooling_type="global_add_pool", dropout=0.0),
    "forgi_instance": dict(norm_type="instance", pooling_type="global_mean_pool",
                           graph_encoding="forgi", normalize_nodes_before_pool=True),
}
RUNS = [(40, True, 0.0), (24, False, 0.2), (24, True, 0.3)]


def _corpus(seed=4, n=6):
    rng = np.random.default_rng(seed)
    out = [random_structure(rng, int(k)) for k in rng.integers(40, 140, size=n)]
    return out + ["((..[[..))..]].." * 4, "." * 30, "(.)" * 20, "((((....))))" * 5, "((..))"]


CORPUS = _corpus()


def _jax_tree(case, seed=8):
    jc = JConfig.create(**{**BASE, **CASES[case]})
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    params = dict(params)
    params["norms"] = [{k: f32((0.0 if k == "bias" else 1.0) + 0.3 * rng.normal(size=v.shape))
                        for k, v in n.items()} for n in params["norms"]]
    state = dict(state)
    state["node_mu"] = f32(0.1 * rng.normal(size=32))
    state["node_sigma"] = f32(1.0 + rng.random(32))
    if "batch_norms" in state:
        state["batch_norms"] = [{"running_mean": f32(0.5 * rng.normal(size=32)),
                                 "running_var": f32(0.3 + 2.0 * rng.random(32))}
                                for _ in range(2)]
    return jc, params, state


def _pair(case):
    jc, params, state = _jax_tree(case)
    pc = GINConfig.create(**{**BASE, **CASES[case]})
    pp, ps = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    return JModel(jc, params, state), GINModel(pc, pp, ps)


def _same(got, ref, tol=TOL):
    assert len(got) == len(ref)
    n = 0
    for (s1, e1), (s0, e0) in zip(got, ref):
        np.testing.assert_array_equal(s1, s0)
        assert e1.dtype == np.float32 and e1.shape == np.asarray(e0).shape
        if len(s1):
            np.testing.assert_allclose(e1, e0, atol=tol, rtol=0)
        n += len(s1)
    return n


@pytest.mark.parametrize("run", range(len(RUNS)))
@pytest.mark.parametrize("case", list(CASES))
def test_compact_path_matches_jax(case, run):
    jm, pm = _pair(case)
    assert not fw._dense_forward_ok(pm.config)
    L, keep, thr = RUNS[run]
    ref = jfw.embed_corpus_windows(jm, CORPUS, L, keep, thr)
    got = fw.embed_corpus_windows(pm, CORPUS, L, keep, thr, device="cpu")
    assert _same(got, ref) > 100


@pytest.mark.parametrize("case", ["layer_mean", "graph_set2set"])
def test_result_does_not_depend_on_the_chunking(case, monkeypatch):
    """Chunks of a few windows and one chunk per group agree."""
    _, pm = _pair(case)
    whole = fw.embed_corpus_windows(pm, CORPUS, 24, True, device="cpu")
    monkeypatch.setattr(fw, "_COMPACT_CHUNK_NODES", 70)
    small = fw.embed_corpus_windows(pm, CORPUS, 24, True, device="cpu")
    _same(small, whole, tol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_embed_structure_windows_matches_corpus(case):
    jm, pm = _pair(case)
    corpus = fw.embed_corpus_windows(pm, CORPUS, 30, True, 0.1, device="cpu")
    for s, (starts, emb) in zip(CORPUS, corpus):
        got = fw.embed_structure_windows(pm, s, 30, True, 0.1, device="cpu")
        np.testing.assert_array_equal(got[0], starts)
        np.testing.assert_allclose(got[1], emb, atol=1e-5, rtol=0)
        if len(s) < 30:
            assert got[0].shape == (0,) and got[1].shape == (0, 24)
    ref = jfw.embed_structure_windows(jm, CORPUS[0], 30, True, 0.1)
    got = fw.embed_structure_windows(pm, CORPUS[0], 30, True, 0.1, device="cpu")
    _same([got], [ref])


def test_short_structures_give_no_windows():
    _, pm = _pair("layer_mean")
    res = fw.embed_corpus_windows(pm, ["((..))", "....", ""], 10, device="cpu")
    assert [(s.shape, e.shape) for s, e in res] == [((0,), (0, 24))] * 3


@pytest.mark.parametrize("keep", [True, False])
def test_window_slot_counts_are_exact(keep):
    """Per-window pulled partners and in-window base pairs from the host
    sweep equal those of the windows built one by one."""
    rng = np.random.default_rng(5)
    for s in _corpus(seed=5, n=4) + [random_structure(rng, 200)]:
        pt = pair_table(s)
        L = 24
        if len(s) < L:
            continue
        starts = np.arange(len(s) - L + 1)
        bp, pulled = fw._window_slot_counts(pt, L, starts, keep)
        for st, g in windows.structure_to_windows(s, L, keep):
            assert pulled[st] == g.n_nodes - L
            assert bp[st] == (g.n_edges - 2 * (L - 1)) // 2 - pulled[st]
        assert (int(bp.max()), int(pulled.max())) == jfw._window_slot_caps(pt, L, starts, keep)


@pytest.mark.parametrize("case", ["batch_add", "forgi_instance"])
def test_fused_cli_matches_jax_and_the_two_step_flow(case, tmp_path):
    """``embed --window-size`` on the compact path: the JAX CLI's bytes
    outside ``embedding_vector`` and vectors within 1e-4; and the port's
    windows CLI then ``embed --graph-pt`` gives the same rows."""
    jc, params, state = _jax_tree(case)
    ckpt = str(tmp_path / "m.pth")
    export_torch_checkpoint(ckpt, jc, params, state)
    src = tmp_path / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure"])
        w.writerows((f"r{i}", s) for i, s in enumerate(CORPUS))
    args = ["--input", str(src), "--id-column", "rid", "--model-path", ckpt,
            "--window-size", "30", "--keep-paired-neighbors", "--quiet"]
    jembed.main([*args, "--output", str(tmp_path / "jax.tsv")])
    embed.main([*args, "--output", str(tmp_path / "fused.tsv"), "--device", "cpu"])
    windows.main(["--input", str(src), "--id-column", "rid", "--L", "30",
                  "--keep-paired-neighbors", "--quiet", "--output-dir", str(tmp_path / "w")])
    embed.main(["--graph-pt", str(tmp_path / "w" / "windows_graphs.npz"), "--meta-tsv",
                str(tmp_path / "w" / "windows_metadata.tsv"), "--id-column", "rid",
                "--model-path", ckpt, "--output", str(tmp_path / "two.tsv"), "--device", "cpu"])

    def read(name):
        with open(tmp_path / name, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        k = rows[0].index("embedding_vector")
        return ([r[:k] + r[k + 1:] for r in rows],
                np.array([r[k].split(",") for r in rows[1:]], np.float64))

    (jt, jv), (ft, fv), (tt, tv) = read("jax.tsv"), read("fused.tsv"), read("two.tsv")
    assert ft == jt and len(ft) > 100
    assert tt == ft
    assert np.abs(fv - jv).max() <= TOL + 1e-6
    assert np.abs(tv - fv).max() <= TOL + 1e-6
