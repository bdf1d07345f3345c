"""The port's windows CLI (``python -m ginfinity_tpu_torch.pipelines.windows``,
the twin of ``ginfinity-generate-windows``) and the ``--graph-pt`` modes of
its embed and node-embed CLIs, against the JAX package's on the CPU.

- ``windows_graphs.npz`` array-equal (tolerance 0) and
  ``windows_metadata.tsv`` byte-identical to the JAX CLI's, with and
  without ``--keep-paired-neighbors`` and ``--mask-threshold``;
- a ``windows_graphs.pt`` written by either package reads in the other,
  whichever package registered its ``torch_geometric`` stand-ins first,
  and a foreign ``.pt`` without our attributes finds its base nodes by
  the reference's fallbacks;
- ``--graph-pt`` TSVs (``.npz`` and ``.pt``) with the JAX CLIs' bytes
  outside ``embedding_vector``/``node_embeddings``, and the vectors
  within 1e-5 (plus the 1e-6 of printing), or, where GraphNorm's
  amplification of float32 order goes beyond, no farther than twice the
  JAX values from a float64 run of the port."""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph_embed import _batch64, _float64

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import embed as jembed
from ginfinity_tpu.pipelines import node_embed as jnode_embed
from ginfinity_tpu.pipelines import windows as jwindows
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs import batching
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.checkpoint import load_checkpoint
from ginfinity_tpu_torch.models.gine import GINModel
from ginfinity_tpu_torch.pipelines import embed, engine, node_embed, windows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PRINT_TOL = TOL + 1e-6
L = 30


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded structures of 20-110 nt (some shorter than L), a pseudoknot,
    an invalid and a missing structure; an int id column, a text column
    with a missing cell and a float column."""
    d = tmp_path_factory.mktemp("windows_cli")
    rng = np.random.default_rng(12)
    rows = [(i, random_structure(rng, int(n)), f"fam{i % 3}" if i % 4 else "", 0.25 * i)
            for i, n in enumerate(rng.integers(20, 110, size=8))]
    rows += [(8, "((..[[..))..]].." * 3, "pk", 1e3), (9, "((..", "bad", 1.0),
             (10, "", "none", 2.0)]
    src = d / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure", "family", "score"])
        w.writerows(rows)
    return d, str(src)


def _windows_both(src, out, extra):
    args = ["--input", src, "--id-column", "rid", "--L", str(L), "--format", "both",
            "--quiet", *extra]
    jwindows.main([*args, "--output-dir", str(out / "jax")])
    windows.main([*args, "--output-dir", str(out / "port")])
    return out / "jax", out / "port"


FLAGS = {
    "plain": [],
    "keep_paired": ["--keep-paired-neighbors"],
    "keep_paired_mask": ["--keep-paired-neighbors", "--mask-threshold", "0.3"],
    "mask_only": ["--mask-threshold", "0.5"],
    "keep_cols": ["--keep-paired-neighbors", "--keep-cols", "score"],
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_windows_cli_matches_jax(corpus, name, tmp_path):
    _, src = corpus
    jdir, pdir = _windows_both(src, tmp_path, FLAGS[name])
    assert (pdir / "windows_metadata.tsv").read_bytes() == \
        (jdir / "windows_metadata.tsv").read_bytes()
    with np.load(jdir / "windows_graphs.npz") as ref, np.load(pdir / "windows_graphs.npz") as got:
        assert got.files == ref.files
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert len(ref["manifest"]) > 20
    log = (pdir / "windows_metadata.log").read_text()
    assert "skipped_invalid_dot_bracket: ID 9" in log and "skipped_not_a_string: ID 10" in log


def test_windows_cli_with_nothing_long_enough(tmp_path):
    src = tmp_path / "short.csv"
    src.write_text("rid,secondary_structure,note\na,((..)),x\n")
    jdir, pdir = _windows_both(str(src), tmp_path, [])
    assert (pdir / "windows_metadata.tsv").read_text() == \
        (jdir / "windows_metadata.tsv").read_text() == \
        "window_id\trid\twindow_start\twindow_end\tseq_len\n"
    assert windows.load_windows_graphs(str(pdir / "windows_graphs.npz")) == {}


@pytest.mark.parametrize("L_, keep", [(12, True), (12, False), (40, True)])
def test_structure_to_windows_equals_jax(L_, keep):
    rng = np.random.default_rng(3)
    structs = [random_structure(rng, int(n)) for n in rng.integers(10, 90, size=6)]
    for s in structs + ["((..[[..))..]]..", "(.)" * 8, "((((....))))" * 3]:
        for thr in (0.0, 0.4):
            got = windows.structure_to_windows(s, L_, keep, thr, 0.3, "ACGU" * 30)
            ref = jwindows.structure_to_windows(s, L_, keep, thr, 0.3, "ACGU" * 30)
            assert [a for a, _ in got] == [a for a, _ in ref]
            for (_, g), (_, r) in zip(got, ref):
                for f in ("node_feat", "edge_src", "edge_dst", "edge_attr"):
                    np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
                    assert getattr(g, f).dtype == getattr(r, f).dtype
                assert (g.n_nodes, g.n_base_nodes) == (r.n_nodes, r.n_base_nodes)


def _same_graphs(a, b):
    assert list(a) == list(b) and len(a) > 0
    for wid in a:
        for f in ("node_feat", "edge_src", "edge_dst", "edge_attr"):
            np.testing.assert_array_equal(getattr(a[wid], f), getattr(b[wid], f))
        assert (a[wid].n_nodes, a[wid].n_base_nodes) == (b[wid].n_nodes, b[wid].n_base_nodes)


def test_pt_archives_read_in_both_packages(corpus, tmp_path):
    _, src = corpus
    jdir, pdir = _windows_both(src, tmp_path, ["--keep-paired-neighbors"])
    npz = windows.load_windows_graphs(str(pdir / "windows_graphs.npz"))
    blob = (pdir / "windows_graphs.pt").read_bytes()
    assert b"torch_geometric.data.data" in blob and b"ginfinity" not in blob
    _same_graphs(windows.load_windows_graphs(str(jdir / "windows_graphs.pt")), npz)
    _same_graphs(jwindows.load_windows_graphs(str(pdir / "windows_graphs.pt")), npz)
    _same_graphs(windows.load_windows_graphs(str(pdir / "windows_graphs.pt")), npz)


_ORDER = """
import json, sys
import numpy as np
first, out = sys.argv[1], sys.argv[2]
if first == "port":
    from ginfinity_tpu_torch.graphs.pyg_compat import ensure_pyg
    ensure_pyg()
    import ginfinity_tpu.graphs.pyg_compat as j
    j.ensure_pyg()
else:
    import ginfinity_tpu.graphs.pyg_compat as j
    j.ensure_pyg()
    from ginfinity_tpu_torch.graphs.pyg_compat import ensure_pyg
    ensure_pyg()
from ginfinity_tpu.pipelines import windows as jw
from ginfinity_tpu_torch.pipelines import windows as pw
g = dict(pw.structure_to_windows("((((....))))..((...))..", 12, True))
graphs = {f"w_{k}": v for k, v in g.items()}
pw.save_windows_graphs_pt(out + "/port.pt", graphs)
jw.save_windows_graphs_pt(out + "/jax.pt", graphs)
res = {}
for reader, mod in (("port", pw), ("jax", jw)):
    for writer in ("port", "jax"):
        got = mod.load_windows_graphs(out + "/" + writer + ".pt")
        res[reader + "<" + writer] = sorted(got) == sorted(graphs) and all(
            np.array_equal(got[w].node_feat, graphs[w].node_feat)
            and np.array_equal(got[w].edge_src, graphs[w].edge_src)
            and got[w].n_base_nodes == graphs[w].n_base_nodes for w in graphs)
print(json.dumps(res))
"""


@pytest.mark.parametrize("first", ["port", "jax"])
def test_pt_cross_read_in_both_import_orders(first, tmp_path):
    """Each package's stand-ins registered first, in a fresh interpreter:
    both writers' archives read in both readers."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _ORDER, first, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {f"{r}<{w}": True for r in ("port", "jax") for w in ("port", "jax")}


def test_foreign_pt_mask_fallbacks(tmp_path):
    """A foreign archive finds its base nodes by ``base_node_mask`` (not
    a prefix: nodes reordered base-first, edges remapped), else the forgi
    ``is_base`` column, else all nodes (mirrors ``tests/test_pipelines.py``)."""
    from ginfinity_tpu_torch.graphs.pyg_compat import ensure_pyg

    Data = ensure_pyg().Data
    is_base = 16 - 7 - 1

    def forgi_x(n, base_rows):
        x = np.zeros((n, 16), np.float32)
        x[base_rows, is_base] = 1.0
        return torch.from_numpy(x)

    ei = torch.tensor([[0, 1, 2], [1, 2, 3]])
    ea = torch.zeros((3, 7))
    d_mask = Data(x=forgi_x(4, [0, 2, 3]), edge_index=ei, edge_attr=ea)
    d_mask.base_node_mask = torch.tensor([True, False, True, True])
    d_num = Data(x=forgi_x(5, [0, 1, 2, 3]), edge_index=ei, edge_attr=ea)
    d_num.num_base_nodes = 2
    d_feat = Data(x=forgi_x(4, [0, 1]), edge_index=ei, edge_attr=ea)
    d_std = Data(x=torch.zeros((4, 4)), edge_index=ei, edge_attr=torch.zeros((3, 4)))
    path = str(tmp_path / "foreign.pt")
    torch.save({"a": d_mask, "n": d_num, "b": d_feat, "c": d_std}, path)

    g = windows.load_windows_graphs(path)
    ref = jwindows.load_windows_graphs(path)
    _same_graphs(g, ref)
    assert [g[k].n_base_nodes for k in "anbc"] == [3, 2, 2, 4]
    assert g["a"].node_feat[:3, is_base].all() and g["a"].node_feat[3, is_base] == 0.0
    perm = {0: 0, 2: 1, 3: 2, 1: 3}
    assert set(zip(g["a"].edge_src.tolist(), g["a"].edge_dst.tolist())) == \
        {(perm[s], perm[d]) for s, d in ((0, 1), (1, 2), (2, 3))}


# ------------------------------------------------------------ --graph-pt

MODELS = {
    "graph_mean": dict(norm_type="graph", pooling_type="global_mean_pool",
                       normalize_nodes_before_pool=True),
    "forgi_graph_add": dict(norm_type="graph", pooling_type="global_add_pool",
                            graph_encoding="forgi"),
    "layer_set2set": dict(norm_type="layer", pooling_type="set2set"),
}


def _checkpoint(d, name, seed=6):
    kw = dict(hidden_dim=32, output_dim=32, gin_layers=2, node_embed_norm="zscore_l2",
              use_residual=True, **MODELS[name])
    jc = JConfig.create(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    state = dict(state)
    state["node_mu"] = jnp.asarray(0.1 * rng.normal(size=32).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(32)).astype(np.float32))
    path = str(d / f"{name}.pth")
    export_torch_checkpoint(path, jc, params, state)
    return path


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _float64_rows(ckpt, graph_pt, meta_tsv, nodes):
    """The port's float64 embeddings of the archive's windows, in
    metadata order."""
    cfg, params, state, _ = load_checkpoint(ckpt)
    model = GINModel(cfg, params, state)
    _, graphs = windows.load_precomputed(graph_pt, meta_tsv)
    graphs = engine.adapt_graphs_to_model(graphs, cfg)
    batch = _batch64(batching.batch_graphs(graphs))
    p, s = _float64(model.params), _float64(model.state)
    if not nodes:
        return gine.forward_once(cfg, p, s, batch).numpy()
    x = gine.get_node_embeddings(cfg, p, s, batch).numpy()
    offs = np.cumsum([0] + [g.n_nodes for g in graphs])
    return [x[o: o + g.n_base_nodes] for o, g in zip(offs, graphs)]


@pytest.fixture(scope="module")
def archive(corpus, tmp_path_factory):
    """The port CLI's windows of the corpus, in both formats."""
    _, src = corpus
    out = tmp_path_factory.mktemp("archive")
    windows.main(["--input", src, "--id-column", "rid", "--L", str(L), "--format", "both",
                  "--keep-paired-neighbors", "--keep-cols", "family,score", "--quiet",
                  "--output-dir", str(out)])
    return out


@pytest.mark.parametrize("fmt", ["npz", "pt"])
@pytest.mark.parametrize("model_name", list(MODELS))
@pytest.mark.parametrize("cli", ["embed", "node_embed"])
def test_graph_pt_tsv_matches_jax(archive, fmt, model_name, cli, tmp_path):
    pdir = archive
    ckpt = _checkpoint(tmp_path, model_name)
    graph_pt, meta = str(pdir / f"windows_graphs.{fmt}"), str(pdir / "windows_metadata.tsv")
    args = ["--graph-pt", graph_pt, "--meta-tsv", meta, "--id-column", "rid",
            "--model-path", ckpt, "--batch-nodes", "700"]
    jmod, pmod, col = ((jembed, embed, "embedding_vector") if cli == "embed"
                       else (jnode_embed, node_embed, "node_embeddings"))
    jmod.main([*args, "--output", str(tmp_path / "jax.tsv")])
    pmod.main([*args, "--output", str(tmp_path / "port.tsv"), "--device", "cpu"])
    ref, got = _read(tmp_path / "jax.tsv"), _read(tmp_path / "port.tsv")
    assert got[0] == ref[0] and len(got) == len(ref) > 20
    k = ref[0].index(col)
    assert [g[:k] + g[k + 1:] for g in got] == [r[:k] + r[k + 1:] for r in ref]
    if cli == "embed":
        gv = [np.array(g[k].split(","), np.float64) for g in got[1:]]
        rv = [np.array(r[k].split(","), np.float64) for r in ref[1:]]
    else:
        gv = [np.array(json.loads(g[k])) for g in got[1:]]
        rv = [np.array(json.loads(r[k])) for r in ref[1:]]
    assert [a.shape for a in gv] == [b.shape for b in rv]
    err = max(np.abs(a - b).max() for a, b in zip(gv, rv))
    if err > PRINT_TOL:
        x64 = _float64_rows(ckpt, graph_pt, meta, cli == "node_embed")
        jax_err = max(np.abs(b - x).max() for b, x in zip(rv, x64))
        port_err = max(np.abs(a - x).max() for a, x in zip(gv, x64))
        assert port_err <= 2 * jax_err + 1e-6, (port_err, jax_err)
    assert (tmp_path / "port.log").exists()
