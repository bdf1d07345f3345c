"""The port's ``msa_eval`` (``ginfinity_tpu_torch/pipelines/msa_eval.py``)
against the JAX package's, on the CPU: the family generator, the truth
scoring, the runners' flags, the embeddings TSV and the MSA runner on it.

Tolerances.  The generator and the scoring are exact (the same draws
from the same seeds, the same integer counts).  The TSV's names and
structures are identical text; its node rows are the node-embedding
path's (``tests/test_torch_node_embed.py``): within 1e-5 of JAX's, plus
the 1e-6 of rounding to 6 decimals, or, where GraphNorm carries float32
order past that, no farther from a float64 run of the port than twice
JAX's rows are.  ``run_repo_msa`` on the same TSV writes JAX's
``.aln.tsv`` byte for byte."""

import csv
import json

import numpy as np
import pytest
from test_torch_graph_embed import _batch64, _float64
from test_torch_node_embed import CONFIGS, _models

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.pipelines import msa_eval as jeval
from ginfinity_tpu_torch.graphs import batching
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.pipelines import engine
from ginfinity_tpu_torch.pipelines import msa as tmsa_cli
from ginfinity_tpu_torch.pipelines import msa_eval as teval

TOL = 1e-5
PRINT_TOL = TOL + 1e-6


def _fields(m):
    return m.name, m.structure, m.sequence, m.posmap.tolist(), m.posmap.dtype


@pytest.mark.parametrize("seed", range(5))
def test_family_generator_identical(seed):
    """``make_family`` at two sizes and rates, ``make_family_from_ancestor``
    on a generated ancestor, and the ancestor's own draws: the same
    members, sequences and position maps."""
    for kw in (dict(n_seqs=5, anc_len=90),
               dict(n_seqs=4, anc_len=160, sub_rate=0.2, del_rate=0.1, ins_rate=0.1)):
        got = teval.make_family(seed, **kw)
        want = jeval.make_family(seed, **kw)
        assert [_fields(m) for m in got] == [_fields(m) for m in want]
    rs, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    struct = teval.random_structure(rs, 140)
    assert struct == jeval.random_structure(rj, 140)
    seq = teval.random_sequence(rs, struct)
    assert seq == jeval.random_sequence(rj, struct)
    got = teval.make_family_from_ancestor(seed + 100, struct, seq, n_seqs=4)
    want = jeval.make_family_from_ancestor(seed + 100, struct, seq, n_seqs=4)
    assert [_fields(m) for m in got] == [_fields(m) for m in want]


def _truth_msa(members):
    """One column per ancestor coordinate plus a column per insertion
    (tests/test_msa_quality.py::test_sp_scores_perfect_on_truth)."""
    keys, per_member = set(), {}
    for mi, m in enumerate(members):
        prev, serial, mkeys = -1, 0, []
        for anc in m.posmap:
            if anc >= 0:
                prev, serial = int(anc), 0
                k = (int(anc), 0, 0, 0)
            else:
                serial += 1
                k = (prev, 1, mi, serial)
            keys.add(k)
            mkeys.append(k)
        per_member[mi] = mkeys
    col_of = {k: i for i, k in enumerate(sorted(keys))}
    msa = {}
    for mi, m in enumerate(members):
        row = ["-"] * len(col_of)
        for k in per_member[mi]:
            row[col_of[k]] = "x"
        msa[m.name] = "".join(row)
    return msa


def test_sp_scores_on_truth_and_shifted():
    """The truth scores recall and precision 1.0 on both sides; one member
    shifted by a column scores the same lower numbers on both."""
    members = teval.make_family(1, n_seqs=4, anc_len=80)
    msa = _truth_msa(members)
    got, want = teval.sp_scores(msa, members), jeval.sp_scores(msa, jeval.make_family(
        1, n_seqs=4, anc_len=80))
    assert got == want
    assert got["sp_recall"] == got["sp_precision"] == 1.0 and got["n_true_pairs"] > 0
    shifted = {k: v + "-" for k, v in msa.items()}
    shifted[members[0].name] = "-" + msa[members[0].name]
    assert teval.sp_scores(shifted, members) == jeval.sp_scores(shifted, members)
    assert teval.sp_scores(shifted, members)["sp_recall"] < 1.0
    with pytest.raises(ValueError, match="names missing"):
        teval.sp_scores({}, members)


def test_param_flags_refine_override_wins():
    """``refine_iters`` reaches the CLI after ``_SHARED_FLAGS``' default
    (tests/test_msa_quality.py:143), and both modules give the same flags."""
    params = {"refine_iters": 3, "alpha": 5, "max_pairs": 9, "refine_min_gain": 0.01}
    flags = teval._param_flags(params)
    assert flags == jeval._param_flags(params) and teval._SHARED_FLAGS == jeval._SHARED_FLAGS
    args = tmsa_cli.build_parser().parse_args(["--input", "dummy", *teval._SHARED_FLAGS, *flags])
    assert args.refine_iters == 3 and args.max_pairs == 9
    assert teval.DEFAULT_PARAMS == jeval.DEFAULT_PARAMS


@pytest.fixture(scope="module")
def family_tsvs(tmp_path_factory):
    """A 6-member family through both ``family_to_tsv`` with one
    checkpoint (2 x 128 GraphNorm, node_mu / node_sigma away from 0 / 1,
    GraphNorm affines perturbed), and the checkpoint's port model."""
    d = tmp_path_factory.mktemp("msa_eval")
    (jc, jp, js), model = _models(CONFIGS["graphnorm_zscore_l2_2x128"], seed=7, norm_noise=0.2)
    ckpt = str(d / "model.pth")
    export_torch_checkpoint(ckpt, jc, jp, js)
    members = teval.make_family(11, n_seqs=6, anc_len=120)
    jeval.family_to_tsv(members, ckpt, str(d / "jax.tsv"))
    teval.family_to_tsv(members, ckpt, str(d / "port.tsv"), device="cpu")
    return members, model, d


def _rows(path):
    with open(path, newline="") as f:
        csv.field_size_limit(2**31 - 1)
        return list(csv.reader(f, delimiter="\t"))


def test_family_to_tsv_matches_jax(family_tsvs):
    members, model, d = family_tsvs
    want, got = _rows(d / "jax.tsv"), _rows(d / "port.tsv")
    assert got[0] == want[0] == ["Name", "node_embeddings", "DotBracket"]
    assert [(r[0], r[2]) for r in got[1:]] == [(r[0], r[2]) for r in want[1:]] == \
        [(m.name, m.structure) for m in members]
    gm = [np.asarray(json.loads(r[1])) for r in got[1:]]
    wm = [np.asarray(json.loads(r[1])) for r in want[1:]]
    err = max(float(np.abs(g - w).max()) for g, w in zip(gm, wm))
    if err > PRINT_TOL:
        graphs = engine.preprocess_structures([m.structure for m in members],
                                              [m.sequence for m in members]).graphs
        batch = batching.batch_graphs(graphs)
        x64 = gine.get_node_embeddings(model.config, _float64(model.params),
                                       _float64(model.state), _batch64(batch)).numpy()
        offs = np.cumsum([0] + [g.n_nodes for g in graphs])
        ref64 = [x64[a:b] for a, b in zip(offs[:-1], offs[1:])]
        jax_err = max(float(np.abs(w - r).max()) for w, r in zip(wm, ref64))
        port_err = max(float(np.abs(g - r).max()) for g, r in zip(gm, ref64))
        assert port_err <= 2 * jax_err + 1e-6, (err, port_err, jax_err)
    for g, m in zip(gm, members):
        assert g.shape == (len(m.structure), 128)
        np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("dp_score", ["profile", "library"])
def test_run_repo_msa_and_scores_match_jax(family_tsvs, dp_score, tmp_path):
    """Both runners on JAX's TSV (profile mode at the reference's
    defaults, library mode): the same ``.aln.tsv``, read back by both
    ``load_aln_tsv`` into one dict, with the same SP scores."""
    members, _, d = family_tsvs
    src = str(d / "jax.tsv")
    params = dict(teval.DEFAULT_PARAMS, refine_iters=2)
    jeval.run_repo_msa(src, str(tmp_path / "j" / "msa"), params, dp_score=dp_score)
    sec = teval.run_repo_msa(src, str(tmp_path / "t" / "msa"), params, dp_score=dp_score,
                             device="cpu")
    assert sec > 0
    jt, tt = (tmp_path / "j" / "msa.aln.tsv").read_bytes(), \
        (tmp_path / "t" / "msa.aln.tsv").read_bytes()
    assert tt == jt
    got = teval.load_aln_tsv(str(tmp_path / "t" / "msa.aln.tsv"))
    assert got == jeval.load_aln_tsv(str(tmp_path / "j" / "msa.aln.tsv"))
    assert teval.sp_scores(got, members) == jeval.sp_scores(got, members)
    assert 0.0 < teval.sp_scores(got, members)["sp_f1"] <= 1.0


def test_load_aln_tsv_typed_names(tmp_path):
    """Names read as pandas types them (``7`` from an int column), as JAX's
    reader gives them."""
    p = tmp_path / "a.aln.tsv"
    p.write_text("Name\tAligned\n7\tAC-G\n12\t-CAG\n")
    assert teval.load_aln_tsv(str(p)) == jeval.load_aln_tsv(str(p)) == \
        {"7": "AC-G", "12": "-CAG"}


def test_reference_parts_fail_without_the_reference(tmp_path, monkeypatch):
    """Where the reference checkout is not named or its files are absent,
    the parts that read them raise ``FileNotFoundError``, as the JAX
    package's do without its checkout; given a checkout, the ancestors
    read as JAX's reader gives them."""
    missing = str(tmp_path / "absent.csv")
    for mod in (teval, jeval):
        with pytest.raises(FileNotFoundError):
            mod.load_reference_ancestors(csv_path=missing)
    monkeypatch.delenv("GINFINITY_REFERENCE_ROOT", raising=False)
    for call in (lambda: teval.load_reference_ancestors(),
                 lambda: teval.run_reference_msa("x.tsv", str(tmp_path / "o"), {}),
                 teval._reference_msa_module):
        with pytest.raises(FileNotFoundError, match="GINFINITY_REFERENCE_ROOT"):
            call()
    root = tmp_path / "ref"
    (root / "example_data").mkdir(parents=True)
    rows = [("URS2", "((....))", "GGAAACCC"), ("URS1", "((.....))", "GGAAAACCC"),
            ("URS3", "(...)", "GAAAC")]
    with open(root / "example_data" / "sample_dataset.csv", "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["rnacentral_id", "secondary_structure", "sequence"])
        w.writerows(rows)
    monkeypatch.setenv("GINFINITY_REFERENCE_ROOT", str(root))
    csv_path = str(root / "example_data" / "sample_dataset.csv")
    for kw in ({}, {"min_len": 6, "limit": 1}):
        assert teval.load_reference_ancestors(**kw) == \
            jeval.load_reference_ancestors(csv_path=csv_path, **kw)


def test_smoke_corpora_unchanged():
    """``chip_smoke.py`` draws its structures with the port's generator
    (once its own copy): its corpora stay byte-identical to the JAX
    generator's draws in the smoke's order (the kernel cases' corpus, the
    window corpus, the alignment structures)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.random_structure is teval.random_structure

    def jax_corpus(rng, n_windows, L):
        out, total = [], 0
        while total < n_windows:
            s = jeval.random_structure(rng, int(rng.integers(150, 351)))
            out.append(s)
            total += len(s) - L + 1
        return out

    got, want = np.random.default_rng(smoke.SEED), np.random.default_rng(smoke.SEED)
    for n_windows in (2000, smoke.N_WINDOWS):
        assert smoke.corpus(got, n_windows, smoke.WINDOW) == jax_corpus(want, n_windows,
                                                                        smoke.WINDOW)
    assert [smoke.random_structure(got, int(got.integers(150, 351))) for _ in range(64)] == \
        [jeval.random_structure(want, int(want.integers(150, 351))) for _ in range(64)]
