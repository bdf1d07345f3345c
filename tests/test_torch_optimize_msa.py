"""The port's ``ginfinity-optimize-msa`` against the JAX package's, on the
CPU (mirrors ``tests/test_aux_pipelines.py::TestOptimizeMsa``): the
seeded random search writes a byte-identical ``trials.csv`` and an equal
``best_params.json``, and the score function, the region parser and the
position map equal JAX's.  Exact: both sides run the same trials with
the same seeded draws, and each trial's alignment is the MSA CLI's,
which both packages write byte for byte (``tests/test_torch_msa.py``)."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from ginfinity_tpu.pipelines import optimize_msa as jopt
from ginfinity_tpu_torch.pipelines import optimize_msa as topt


def _msa_input(tmp_path, n_seq=3, L=18, d=8, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(L, d)).astype(np.float32)
    rows = []
    for k in range(n_seq):
        emb = base + 0.02 * rng.normal(size=base.shape).astype(np.float32)
        rows.append({
            "Name": f"r{k}",
            "node_embeddings": json.dumps(emb.round(6).tolist()),
            "DotBracket": "(((" + "." * (L - 6) + ")))",
        })
    p = tmp_path / "in.tsv"
    pd.DataFrame(rows).to_csv(p, sep="\t", index=False)
    return str(p)


@pytest.mark.parametrize("n_trials, extra", [(2, []), (3, ["--no-plot-diagnostics",
                                                            "--tree", "upgma"])])
def test_random_search_matches_jax(tmp_path, n_trials, extra):
    inp = _msa_input(tmp_path)
    regions = tmp_path / "regions.tsv"
    regions.write_text("Name\tStart\tEnd\nr0\t2\t9\nr1\t2\t9\n")
    argv = ["--input", inp, "--regions-tsv", str(regions), "--name-a", "r0", "--name-b", "r1",
            "--n-trials", str(n_trials), "--study-name", "t", "--topk", "8",
            "--consistency-rounds", "1", "--max-pairs", "10", "--dotbracket-col",
            "DotBracket", *extra]
    jopt.main(argv + ["--outdir", str(tmp_path / "jax")])
    topt.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    jdir, tdir = tmp_path / "jax" / "t", tmp_path / "port" / "t"
    assert (tdir / "trials.csv").read_bytes() == (jdir / "trials.csv").read_bytes()
    trials = pd.read_csv(tdir / "trials.csv")
    assert len(trials) == n_trials and np.isfinite(trials["value"]).all()
    assert trials["value"].max() == 8  # near-identical records: the region co-aligns
    best = json.loads((tdir / "best_params.json").read_text())
    assert best == json.loads((jdir / "best_params.json").read_text())
    assert set(best) == set(topt.PARAM_KEYS) and isinstance(best["refine_iters"], int)
    for t in range(n_trials):
        meta = json.loads((tdir / f"trial_rs{t}" / "trial_meta.json").read_text())
        want = json.loads((jdir / f"trial_rs{t}" / "trial_meta.json").read_text())
        assert (meta["params"], meta["score"]) == (want["params"], want["score"])
        got_aln = (tdir / f"trial_rs{t}" / "msa.aln.tsv").read_bytes()
        assert got_aln == (jdir / f"trial_rs{t}" / "msa.aln.tsv").read_bytes()


def test_failed_trial_scores_minus_1e9(tmp_path):
    """A trial whose names are not in the alignment scores -1e9 and leaves
    its error, on both sides; the summary still writes."""
    inp = _msa_input(tmp_path)
    regions = tmp_path / "regions.tsv"
    regions.write_text("Name\tStart\tEnd\nr0\t2\t9\nzz\t2\t9\n")
    argv = ["--input", inp, "--regions-tsv", str(regions), "--name-a", "r0", "--name-b", "zz",
            "--n-trials", "1", "--study-name", "t", "--topk", "8", "--consistency-rounds",
            "1", "--no-plot-diagnostics"]
    jopt.main(argv + ["--outdir", str(tmp_path / "jax")])
    topt.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    for side in ("jax", "port"):
        assert "zz" in (tmp_path / side / "t" / "trial_rs0" / "error.txt").read_text()
    assert (tmp_path / "port" / "t" / "trials.csv").read_bytes() == \
        (tmp_path / "jax" / "t" / "trials.csv").read_bytes()
    assert b"-1000000000.0" in (tmp_path / "port" / "t" / "trials.csv").read_bytes()


def test_score_function_and_helpers(tmp_path):
    msa = {"a": "AC-GU", "b": "AC-GU", "c": "-ACGU"}
    regions = {"a": (1, 4), "b": (1, 4), "c": (1, 4)}
    for pair in (("a", "b"), ("a", "c"), ("c", "b")):
        assert topt.compute_score(msa, regions, *pair) == jopt.compute_score(msa, regions, *pair)
    assert topt.compute_score(msa, regions, "a", "b") == 4
    assert topt.compute_score(msa, regions, "a", "c") < 4
    for fn in (topt.compute_score, jopt.compute_score):
        with pytest.raises(ValueError, match="not in MSA"):
            fn(msa, regions, "a", "x")
        with pytest.raises(ValueError, match="Region lengths differ"):
            fn(msa, {"a": (1, 4), "b": (1, 3)}, "a", "b")
    for aligned in ("AC-GU", "---", "A--C-"):
        assert topt.build_pos_to_col_map(aligned) == jopt.build_pos_to_col_map(aligned)
    p = tmp_path / "r.tsv"
    p.write_text("Name\tStart\tEnd\nx\t3\t9\nbad\tq\t1\nshort\t1\ny 1 7\n")
    assert topt.parse_regions_tsv(p) == jopt.parse_regions_tsv(p) == {"x": (3, 9), "y": (1, 7)}
    p.write_text("Name\tStart\tEnd\n")
    with pytest.raises(ValueError, match="No regions"):
        topt.parse_regions_tsv(p)
    import random

    assert topt._sample_params(random.Random(42)) == jopt._sample_params(random.Random(42))


def test_parser_superset_and_cpu_refusal(tmp_path, monkeypatch):
    """Every JAX flag with its default, plus ``--device``; without a card
    the CLI raises before any trial runs."""
    import argparse

    ref = {}

    def capture(self, *a, **kw):
        ref["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jopt.main([])
    monkeypatch.undo()
    opts = lambda p: {o: a for a in p._actions for o in a.option_strings}  # noqa: E731
    want, got = opts(ref["parser"]), opts(topt.build_parser())
    assert set(want) <= set(got) and "--device" in got
    for o, a in want.items():
        b = got[o]
        assert (b.default, b.required, b.choices, b.type, b.dest) == \
            (a.default, a.required, a.choices, a.type, a.dest), o
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topt.main(["--input", "x.tsv", "--regions-tsv", "r.tsv", "--name-a", "a",
                   "--name-b", "b", "--outdir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
