"""The port's ``ginfinity-embed --window-size`` against the JAX CLI on the
same CSV and checkpoint: the same columns, rows and ``%.6f`` formatting,
embeddings within 1e-5 once parsed (the printed six decimals round each
side's float32 value, so two strings may differ in their last digit);
and the port's parser is a flag superset of the JAX parser with the
same defaults."""

import csv
import re

import jax
import numpy as np
import pytest

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import embed as jembed
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.pipelines import embed

TOL = 1e-5
NUM = re.compile(r"^-?\d+\.\d{6}$")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    jc = JConfig.create(hidden_dim=128, output_dim=128, gin_layers=2,
                        pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                        norm_type="graph", use_residual=True,
                        normalize_nodes_before_pool=True)
    params, state = jinit(jax.random.PRNGKey(4), jc)
    rng = np.random.default_rng(4)
    state = dict(state)
    state["node_mu"] = 0.1 * rng.normal(size=128).astype(np.float32)
    state["node_sigma"] = (1.0 + rng.random(128)).astype(np.float32)
    model = str(d / "model.pth")
    export_torch_checkpoint(model, jc, params, state)
    rows = [(f"r{i}", random_structure(rng, int(n)), f"fam {i % 3}", str(i))
            for i, n in enumerate(rng.integers(45, 110, size=5))]
    rows.append(("bad", "((..", "fam x", "9"))       # invalid: logged, skipped
    rows.append(("short", "((...))", "fam y", "10"))  # no window of this length
    rows.append(("pk", "((..[[..))..]].." * 4, "", "11"))  # empty cell: NaN
    src = d / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure", "family", "rank"])
        w.writerows(rows)
    return d, str(src), model


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _run_both(src, model, window, extra, tmp_path):
    """The JAX CLI and the port on the same input: both TSVs as rows."""
    args = ["--input", src, "--id-column", "rid", "--model-path", model,
            "--window-size", str(window), "--quiet", *extra]
    jembed.main([*args, "--output", str(tmp_path / "jax.tsv")])
    embed.main([*args, "--output", str(tmp_path / "port.tsv"), "--device", "cpu"])
    return _read(tmp_path / "jax.tsv"), _read(tmp_path / "port.tsv")


@pytest.mark.parametrize("extra", [
    ["--keep-paired-neighbors"],
    ["--mask-threshold", "0.3"],
    ["--keep-paired-neighbors", "--keep-cols", "family"],
])
def test_tsv_matches_jax_cli(inputs, extra, tmp_path):
    _, src, model = inputs
    ref, got = _run_both(src, model, 40, extra, tmp_path)
    assert got[0] == ref[0]
    assert len(got) == len(ref) > 1
    col = ref[0].index("embedding_vector")
    for g, r in zip(got[1:], ref[1:]):
        assert g[:col] + g[col + 1:] == r[:col] + r[col + 1:]
        gv, rv = g[col].split(","), r[col].split(",")
        assert len(gv) == len(rv) == 128 and all(NUM.match(v) for v in gv)
        np.testing.assert_allclose(np.array(gv, np.float64), np.array(rv, np.float64),
                                   atol=TOL, rtol=0)
    log = (tmp_path / "port.log").read_text()
    assert "skipped_invalid_structure: ID bad" in log
    assert "num_window_embeddings" in log


@pytest.mark.parametrize("extra", [[], ["--keep-paired-neighbors", "--keep-cols", "rank,score"]])
def test_typed_columns_match_jax_cli(inputs, extra, tmp_path):
    """Ids and kept columns carry the types pandas gives them: ``007`` and
    ``1e3`` are floats (``7.0``, ``1000.0``, so ``window_id`` is
    ``7.0_0``), ``0.50`` prints as ``0.5``, and an int column with a gap
    is float (``3.0``, ``NaN``).  Every line but the embedding is
    byte-identical to the JAX CLI's."""
    d, _, model = inputs
    rng = np.random.default_rng(1)
    s1, s2 = random_structure(rng, 50), random_structure(rng, 50)
    src = tmp_path / "typed.csv"
    src.write_text(f"rid,secondary_structure,score,rank\n007,{s1},0.50,3\n1e3,{s2},1.0,\n")
    ref, got = _run_both(str(src), model, 45, extra, tmp_path)
    col = ref[0].index("embedding_vector")
    assert got[0] == ref[0] and len(got) == len(ref) == 13
    for g, r in zip(got[1:], ref[1:]):
        assert g[:col] + g[col + 1:] == r[:col] + r[col + 1:]
        np.testing.assert_allclose(np.array(g[col].split(","), np.float64),
                                   np.array(r[col].split(","), np.float64), atol=TOL, rtol=0)
    rows = [dict(zip(got[0], g)) for g in got[1:]]
    assert [rows[0][c] for c in ("window_id", "rid", "score", "rank")] == \
        ["7.0_0", "7.0", "0.5", "3.0"]
    assert [rows[-1][c] for c in ("window_id", "rid", "score", "rank")] == \
        ["1000.0_5", "1000.0", "1.0", "NaN"]


def test_no_windows_writes_header_only(inputs, tmp_path):
    _, src, model = inputs
    out = tmp_path / "empty.tsv"
    embed.main(["--input", src, "--id-column", "rid", "--model-path", model,
                "--window-size", "500", "--quiet", "--output", str(out),
                "--device", "cpu"])
    assert _read(out) == [["window_id", "rid", "window_start", "window_end",
                           "seq_len", "embedding_vector"]]


def test_format_embedding_matches_jax():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=200).astype(np.float32) * 10,
                        np.float32([0.0, -0.0, 1e-7, -5e-7, 0.5e-6, 123456.78])])
    assert embed.format_embedding(v) == jembed.format_embedding(v)


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def test_parser_is_flag_superset_with_same_defaults():
    ref, got = _options(jembed.build_parser()), _options(embed.build_parser())
    assert set(ref) <= set(got)
    for opt, a in ref.items():
        b = got[opt]
        assert (b.default, b.required, b.choices, b.type, b.nargs, b.const) == \
            (a.default, a.required, a.choices, a.type, a.nargs, a.const), opt


@pytest.mark.parametrize("extra, exc", [
    (["--graph-pt", "g.npz"], SystemExit),
    (["--wire", "f16"], SystemExit),
])
def test_unported_modes_raise(inputs, extra, exc, tmp_path):
    _, src, model = inputs
    args = ["--input", src, "--id-column", "rid", "--model-path", model, "--quiet",
            "--output", str(tmp_path / "o.tsv"), "--device", "cpu"]
    with pytest.raises(exc):
        embed.main([*args, *extra])
