"""The port's alignment CLIs against the JAX package's on the same
node-embeddings TSV (made by the JAX CLI from a JAX-exported ``.pth``
and 6 seeded structures, string ids): ``ginfinity-align-node-embeddings``
and ``ginfinity-align-node-embeddings-batch`` must write byte-identical
``alignment.tsv``, ``structures.txt``, ``matrix.tsv`` and ``summary.tsv``
in both modes, at the CLI's default gaps and at (-10, -0.5).  Both sides
compute the similarity in numpy float32 on the host and run the same DP,
so there is no tolerance: a differing path, score digit or cell is a
fault.  The port runs with ``--device cpu`` (its plain wavefront)."""

import argparse
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import align as jalign
from ginfinity_tpu.pipelines import align_batch as jalign_batch
from ginfinity_tpu.pipelines import node_embed as jnode_embed
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.pipelines import align, align_batch, node_embed
from ginfinity_tpu_torch.utils.io import read_table_auto

IDS = ["rna_a", "rna_b", "x-7.1", "rna d", "rna_e", "rna/f"]
GAPS = {"default": [], "-10_-0.5": ["--gap-open", "-10", "--gap-extend", "-0.5"]}
MODES = ["global", "local"]


@pytest.fixture(scope="module")
def embeddings(tmp_path_factory):
    d = tmp_path_factory.mktemp("align_cli")
    jc = JConfig.create(hidden_dim=128, output_dim=128, gin_layers=2,
                        pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                        norm_type="graph", use_residual=True,
                        normalize_nodes_before_pool=True)
    params, state = jinit(jax.random.PRNGKey(6), jc)
    rng = np.random.default_rng(6)
    state = dict(state)
    state["node_mu"] = jnp.asarray(0.1 * rng.normal(size=128).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(128)).astype(np.float32))
    model = str(d / "model.pth")
    export_torch_checkpoint(model, jc, params, state)
    src = d / "structures.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure"])
        w.writerows((rid, random_structure(rng, int(n)))
                    for rid, n in zip(IDS, rng.integers(20, 70, size=len(IDS))))
    args = ["--input", str(src), "--id-column", "rid", "--model-path", model, "--quiet",
            "--keep-cols", "secondary_structure"]
    jax_tsv, port_tsv = str(d / "jax_nodes.tsv"), str(d / "port_nodes.tsv")
    jnode_embed.main([*args, "--output", jax_tsv])
    node_embed.main([*args, "--output", port_tsv, "--device", "cpu"])
    return jax_tsv, port_tsv


@pytest.fixture(scope="module")
def int_id_embeddings(tmp_path_factory, embeddings):
    """Node embeddings of RNAs with int ids (``1``, ``2``, ``3``), a float
    column and an int column with a gap, by each CLI (the model of
    ``embeddings``)."""
    d = tmp_path_factory.mktemp("int_ids")
    model = os.path.join(os.path.dirname(embeddings[0]), "model.pth")
    rng = np.random.default_rng(1)
    lines = [f"{i},{random_structure(rng, 50)},{sc},{rk}"
             for i, sc, rk in ((1, "0.50", "3"), (2, "1.0", ""), (3, "2", "5"))]
    src = d / "structures.csv"
    src.write_text("rid,secondary_structure,score,rank\n" + "\n".join(lines) + "\n")
    args = ["--input", str(src), "--id-column", "rid", "--model-path", model, "--quiet",
            "--keep-cols", "secondary_structure,score,rank"]
    jax_tsv, port_tsv = str(d / "jax_nodes.tsv"), str(d / "port_nodes.tsv")
    jnode_embed.main([*args, "--output", jax_tsv])
    node_embed.main([*args, "--output", port_tsv, "--device", "cpu"])
    return jax_tsv, port_tsv


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_node_embed_tsvs_agree(embeddings):
    """The port's node-embeddings TSV of the same inputs: same columns and
    rows, matrices within 1e-5 (+1e-6 printing) once parsed."""
    ref, got = (read_table_auto(p) for p in embeddings)
    assert got.columns == ref.columns == ["rid", "node_embeddings", "secondary_structure"]
    assert got.column("rid") == ref.column("rid") == IDS
    for g, r in zip(got.rows, ref.rows):
        assert g["secondary_structure"] == r["secondary_structure"]
        np.testing.assert_allclose(node_embed.parse_matrix(g["node_embeddings"]),
                                   node_embed.parse_matrix(r["node_embeddings"]),
                                   atol=1.1e-5, rtol=0)


def test_node_embed_int_ids_match_jax(int_id_embeddings):
    """Every column but the matrices is byte-identical: ``1``, ``0.5``,
    ``3.0`` and ``NaN`` as pandas writes them."""
    ref, got = ([ln.split("\t") for ln in _bytes(p).decode().splitlines()]
                for p in int_id_embeddings)
    assert got[0] == ref[0] == ["rid", "node_embeddings", "rank", "score",
                                "secondary_structure"]
    assert len(got) == len(ref) == 4
    for g, r in zip(got[1:], ref[1:]):
        assert g[:1] + g[2:] == r[:1] + r[2:]
        np.testing.assert_allclose(node_embed.parse_matrix(g[1]), node_embed.parse_matrix(r[1]),
                                   atol=1.1e-5, rtol=0)
    assert [g[:1] + g[2:4] for g in got[1:]] == [["1", "3.0", "0.5"], ["2", "NaN", "1.0"],
                                                 ["3", "5.0", "2.0"]]


@pytest.mark.parametrize("main", [jalign.main, align.main], ids=["jax", "port"])
def test_align_int_id_column_rejects_text_id(int_id_embeddings, main, tmp_path):
    """``--rna1 1`` is the text ``1``; against an int id column it finds no
    row, in the port as in the JAX CLI."""
    args = ["--input", int_id_embeddings[0], "--id-column", "rid", "--rna1", "1",
            "--rna2", "2", "--output-prefix", str(tmp_path / "o")]
    if main is align.main:
        args += ["--device", "cpu"]
    with pytest.raises(ValueError, match="^No row found where rid == 1$"):
        main(args)


@pytest.mark.parametrize("mode", MODES)
def test_align_batch_int_ids_byte_identical(int_id_embeddings, mode, tmp_path):
    src = int_id_embeddings[0]
    args = ["--input", src, "--id-column", "rid", "--mode", mode, "--batch-size", "2",
            "--structure-column-name", "secondary_structure", "--write-alignment"]
    jalign_batch.main([*args, "--output-dir", str(tmp_path / "jax")])
    align_batch.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    ref, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(ref) and len(ref) == 1 + 2 * 3
    for name in ref:
        assert got[name] == ref[name], name
    assert b"\n1\t2\t" in got["summary.tsv"]


@pytest.mark.parametrize("pair", [("rna_a", "x-7.1"), ("rna d", "rna/f")])
@pytest.mark.parametrize("gaps", sorted(GAPS))
@pytest.mark.parametrize("mode", MODES)
def test_align_byte_identical(embeddings, pair, gaps, mode, tmp_path):
    src = embeddings[0]
    args = ["--input", src, "--id-column", "rid", "--rna1", pair[0], "--rna2", pair[1],
            "--mode", mode, "--structure-column-name", "secondary_structure", *GAPS[gaps]]
    jalign.main([*args, "--output-prefix", str(tmp_path / "jax" / "out")])
    align.main([*args, "--output-prefix", str(tmp_path / "port" / "out"), "--device", "cpu"])
    for suffix in (".alignment.tsv", ".structures.txt", ".matrix.tsv"):
        ref = _bytes(tmp_path / "jax" / f"out{suffix}")
        assert _bytes(tmp_path / "port" / f"out{suffix}") == ref, suffix
    assert f'# mode="{mode}"'.encode() in _bytes(tmp_path / "port" / "out.alignment.tsv")


@pytest.fixture(scope="module")
def flag_inputs(embeddings, tmp_path_factory):
    """The node-embeddings TSV plus a record ``solo`` of a single node, and
    a base-embeddings TSV: ``base_embeddings`` with BOS/EOS rows (L + 2,
    trimmed by both CLIs) for some RNAs and L rows for the others, and an
    ``alt_base`` column of another width."""
    from ginfinity_tpu.pipelines.node_embed import serialize_matrix

    d = tmp_path_factory.mktemp("align_flags")
    table = read_table_auto(embeddings[0])
    rng = np.random.default_rng(4)
    nodes = d / "nodes.tsv"
    with open(nodes, "w") as f:
        f.write("\t".join(table.columns) + "\n")
        for r in table.rows:
            f.write("\t".join(str(r[c]) for c in table.columns) + "\n")
        solo = rng.normal(size=(1, 128)).astype(np.float32)
        f.write(f"solo\t{serialize_matrix(solo)}\t.\n")
    base = d / "base.tsv"
    with open(base, "w") as f:
        f.write("rid\tbase_embeddings\talt_base\n")
        for k, r in enumerate(table.rows + [{"rid": "solo", "node_embeddings": "[[0]]"}]):
            n = node_embed.parse_matrix(r["node_embeddings"]).shape[0]
            b = rng.normal(size=(n + 2 * (k % 2), 6)).astype(np.float32)
            alt = rng.normal(size=(n, 4)).astype(np.float32)
            f.write(f"{r['rid']}\t{serialize_matrix(b)}\t{serialize_matrix(alt)}\n")
    return str(nodes), str(base)


# (pair, flags, whether the base similarity is blended in): rows 1, 3 and
# 5 of the base TSV carry BOS/EOS rows, so a pair of one with and one
# without is a length mismatch that both CLIs skip with a warning
FLAG_CASES = {
    "seq_weight_0.3": (("rna_a", "x-7.1"), ["--seq-weight", "0.3"], True),
    "seq_weight_0.7": (("rna_b", "rna d"), ["--seq-weight", "0.7"], True),
    "base_embeds_col": (("rna_a", "rna_e"), ["--seq-weight", "0.5", "--base-embeds-col",
                                             "alt_base"], True),
    "save_components": (("x-7.1", "rna_e"), ["--seq-weight", "0.3", "--save-components"],
                        True),
    "local": (("rna_b", "rna/f"), ["--seq-weight", "0.3", "--mode", "local"], True),
    "length_mismatch": (("rna_a", "rna_b"), ["--seq-weight", "0.3", "--save-components"],
                        False),
    "single_node": (("solo", "rna_e"), ["--seq-weight", "0.3", "--save-components"], True),
    "single_node_local": (("rna_a", "solo"), ["--mode", "local"], False),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_align_flags_byte_identical(flag_inputs, case, tmp_path):
    """``--seq-weight``, ``--base-input``, ``--base-embeds-col``,
    ``--save-components``, local mode and a single-node record: every
    file the JAX CLI writes, byte for byte."""
    nodes, base = flag_inputs
    pair, extra, blended = FLAG_CASES[case]
    args = ["--input", nodes, "--id-column", "rid", "--rna1", pair[0], "--rna2", pair[1],
            "--base-input", base, "--structure-column-name", "secondary_structure", *extra]
    jalign.main([*args, "--output-prefix", str(tmp_path / "jax" / "out")])
    align.main([*args, "--output-prefix", str(tmp_path / "port" / "out"), "--device", "cpu"])
    ref, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name
    assert (b"# seq_weight=" in got["out.alignment.tsv"]) == blended
    assert ("out.matrix.base.tsv" in got) == (blended and "--save-components" in extra)


def test_align_default_prefix_and_no_structures(embeddings, tmp_path, monkeypatch):
    """Without --output-prefix both write next to the working directory
    under ``<input stem>__<rna1>__vs__<rna2>``; without a structure column
    there is no structures.txt and the alignment has no char columns."""
    src = embeddings[0]
    stem = os.path.splitext(os.path.basename(src))[0]
    args = ["--input", src, "--id-column", "rid", "--rna1", "rna_b", "--rna2", "rna_e"]
    for name, run in (("jax", lambda: jalign.main(args)),
                      ("port", lambda: align.main([*args, "--device", "cpu"]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run()
    for suffix in (".alignment.tsv", ".matrix.tsv"):
        f = f"{stem}__rna_b__vs__rna_e{suffix}"
        assert _bytes(tmp_path / "port" / f) == _bytes(tmp_path / "jax" / f)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


@pytest.mark.parametrize("gaps", sorted(GAPS))
@pytest.mark.parametrize("mode", MODES)
def test_align_batch_byte_identical(embeddings, gaps, mode, tmp_path):
    src = embeddings[0]
    args = ["--input", src, "--id-column", "rid", "--mode", mode, "--batch-size", "4",
            "--structure-column-name", "secondary_structure", "--write-alignment",
            "--write-matrix", *GAPS[gaps]]
    jalign_batch.main([*args, "--output-dir", str(tmp_path / "jax")])
    align_batch.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    ref, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(ref)
    assert len(ref) == 1 + 3 * 15  # summary + (alignment, structures, matrix) per pair
    for name in ref:
        assert got[name] == ref[name], name


def test_align_batch_summary_only_and_data_parallel(embeddings, tmp_path):
    src = embeddings[1]  # the port's own node embeddings
    args = ["--input", src, "--id-column", "rid", "--summary", "s.tsv", "--data-parallel"]
    jalign_batch.main([*args, "--output-dir", str(tmp_path / "jax")])
    align_batch.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert os.listdir(tmp_path / "port") == ["s.tsv"]
    assert _bytes(tmp_path / "port" / "s.tsv") == _bytes(tmp_path / "jax" / "s.tsv")


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def _parser_of(main):
    """The parser a ``main`` builds, captured at its parse_args call."""
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["p"]


@pytest.mark.parametrize("ref, got", [
    (jalign.build_parser, align.build_parser),
    (lambda: _parser_of(jalign_batch.main), align_batch.build_parser),
], ids=["align", "align_batch"])
def test_parser_is_flag_superset_with_same_defaults(ref, got):
    ref, got = _options(ref()), _options(got())
    assert set(ref) <= set(got) and "--device" in got
    for opt, a in ref.items():
        b = got[opt]
        assert (b.default, b.required, b.choices, b.type, b.nargs, b.const, b.dest,
                b.help == argparse.SUPPRESS) == \
            (a.default, a.required, a.choices, a.type, a.nargs, a.const, a.dest,
             a.help == argparse.SUPPRESS), opt


def test_deprecated_gap_shim(embeddings, tmp_path):
    """--gap X stands for --gap-open X (and --gap-extend keeps -1.0)."""
    src = embeddings[0]
    args = ["--input", src, "--id-column", "rid", "--rna1", "rna_a", "--rna2", "rna_b",
            "--gap", "-3"]
    jalign.main([*args, "--output-prefix", str(tmp_path / "jax")])
    align.main([*args, "--output-prefix", str(tmp_path / "port"), "--device", "cpu"])
    got = _bytes(tmp_path / "port.alignment.tsv")
    assert got == _bytes(tmp_path / "jax.alignment.tsv")
    assert b'# gap_open="-3.0"' in got and b'# gap_extend="-1.0"' in got


@pytest.mark.parametrize("rna2, exc", [("nope", ValueError), ("rna_b", None)])
def test_align_errors_and_html_without_plotly(embeddings, rna2, exc, tmp_path, capsys):
    src = embeddings[0]
    args = ["--input", src, "--id-column", "rid", "--rna1", "rna_a", "--rna2", rna2,
            "--output-prefix", str(tmp_path / "o"), "--device", "cpu"]
    if exc:
        with pytest.raises(exc, match="No row found"):
            align.main(args)
        return
    align.save_matrix_html(np.zeros((2, 2), np.float32), str(tmp_path / "m.html"))
    try:
        import plotly  # noqa: F401
    except ImportError:
        assert "skipping HTML heatmap" in capsys.readouterr().out
        assert not (tmp_path / "m.html").exists()


def test_read_table_auto_sniffs_other_names(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("a;b\n1;x\n2;y\n")
    t = read_table_auto(str(p))
    assert t.columns == ["a", "b"] and t.column("b") == ["x", "y"]
    q = tmp_path / "t.tsv"
    q.write_text("a\tb\n1\t\n")
    assert read_table_auto(str(q)).rows == [{"a": 1, "b": None}]


def test_read_table_takes_megabyte_cells(tmp_path):
    """A 350 x 128 node-embeddings matrix is ~0.5 MB of JSON in one cell."""
    cell = node_embed.serialize_matrix(np.random.default_rng(0).normal(size=(350, 128)))
    assert len(cell) > 131072
    p = tmp_path / "big.tsv"
    p.write_text(f"rid\tnode_embeddings\nr0\t{cell}\n")
    t = read_table_auto(str(p))
    assert t.rows[0]["node_embeddings"] == cell
