"""The port's ``ginfinity-compute-distances`` against the JAX CLI on the
same TSV: all pairs (``--mode 1``) and one query against the rest
(``--mode 2``), with and without ``--top-k``.

Every column but ``distance`` is byte-identical.  ``distance`` is held by
value: the two sides sum the squared differences in another order, so
the all-pairs distances agree to relative 1e-6, not bit for bit.  The
top-k distances are ``|q|^2 - (2 q.c - |c|^2)`` on both sides, which
cancels, so they are held to 1e-5 (|q|^2 + |c|^2); the neighbours are
identical except where two of a query's JAX distances lie within that
tolerance of each other."""

import argparse
import csv
import io

import numpy as np
import pandas as pd
import pytest

from ginfinity_tpu.pipelines import distances as jdist
from ginfinity_tpu_torch.pipelines import distances
from ginfinity_tpu_torch.utils.io import write_tsv

REL = 1e-6
TOPK_TOL = 1e-5


def _write_input(path, ids, emb, extra=None):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        cols = ["rid", "embedding_vector"] + list(extra or {})
        w.writerow(cols)
        for k, (rid, v) in enumerate(zip(ids, emb)):
            w.writerow([rid, ",".join(f"{x:.6f}" for x in v)]
                       + [extra[c][k] for c in (extra or {})])


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """40 rows of 128-wide embeddings at the scale of pooled rows (not
    unit rows), two of them repeated exactly, a text and an int column
    with missing cells."""
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(9)
    emb = (rng.normal(size=(40, 128)) * rng.uniform(0.2, 3.0, size=(40, 1))).astype(np.float32)
    emb[17] = emb[3]
    emb[31] = emb[3]
    emb[25] = emb[8]
    ids = [f"r{i}" for i in range(40)]
    extra = {"family": [f"fam {i % 3}" if i % 5 else "" for i in range(40)],
             "rank": [str(i) if i % 7 else "" for i in range(40)]}
    src = str(d / "emb.tsv")
    _write_input(src, ids, emb, extra)
    parsed = distances.parse_embedding_column(
        [",".join(f"{x:.6f}" for x in v) for v in emb])
    return src, parsed


def _run_both(src, extra, tmp_path, capsys):
    jdist.main(["--input", src, "--output", str(tmp_path / "jax.tsv"), *extra])
    jout = capsys.readouterr().out
    distances.main(["--input", src, "--output", str(tmp_path / "port.tsv"), "--device", "cpu",
                    *extra])
    pout = capsys.readouterr().out
    assert pout.replace("port.tsv", "jax.tsv") == jout
    with open(tmp_path / "jax.tsv", newline="") as f:
        ref = list(csv.reader(f, delimiter="\t"))
    with open(tmp_path / "port.tsv", newline="") as f:
        got = list(csv.reader(f, delimiter="\t"))
    return ref, got


@pytest.mark.parametrize("extra", [
    ["--id-column", "rid"],
    ["--id-column", "rid", "--keep-cols", "rid,family,rank", "--batch-size", "100"],
    ["--id-column", "rid", "--mode", "2", "--query", "r3"],
    ["--id-column", "rank", "--keep-cols", "rid,rank", "--mode", "2", "--query", "15.0"],
])
def test_pairs_match_jax_cli(table, extra, tmp_path, capsys):
    src, _ = table
    ref, got = _run_both(src, extra, tmp_path, capsys)
    assert got[0] == ref[0] and got[0][-1] == "distance"
    assert len(got) == len(ref) > 1
    for g, r in zip(got[1:], ref[1:]):
        assert g[:-1] == r[:-1]
    gd = np.array([g[-1] for g in got[1:]], np.float64)
    rd = np.array([r[-1] for r in ref[1:]], np.float64)
    np.testing.assert_allclose(gd, rd, rtol=REL, atol=0)
    assert (gd == 0).sum() == (rd == 0).sum() > 0 or "--mode" in extra


def _neighbours(rows):
    """``{query: [(neighbour, distance, row), ...]}`` in file order."""
    out: dict = {}
    for r in rows[1:]:
        out.setdefault(r[0], []).append((r[len(rows[0]) // 2], float(r[-1]), r))
    return out


@pytest.mark.parametrize("extra", [
    ["--top-k", "5"],
    ["--top-k", "1", "--keep-cols", "rid,family"],
    ["--top-k", "60"],  # more than the corpus holds
    ["--top-k", "4", "--mode", "2", "--query", "r3"],
    ["--top-k", "2", "--mode", "2", "--query", "r8", "--keep-cols", "rid,rank"],
])
def test_top_k_matches_jax_cli(table, extra, tmp_path, capsys):
    src, emb = table
    ref, got = _run_both(src, ["--id-column", "rid", *extra], tmp_path, capsys)
    assert got[0] == ref[0] and len(got) == len(ref) > 1
    sq = {f"r{i}": float(np.sum(emb[i].astype(np.float64) ** 2)) for i in range(len(emb))}
    rn, gn = _neighbours(ref), _neighbours(got)
    assert list(gn) == list(rn)
    for q in rn:
        r_ids, r_d, r_rows = zip(*rn[q])
        g_ids, g_d, g_rows = zip(*gn[q])
        assert len(g_ids) == len(r_ids)
        tol = TOPK_TOL * (sq[q] + max(sq[c] for c in r_ids + g_ids))
        np.testing.assert_allclose(g_d, r_d, rtol=0, atol=tol)
        for j, (g, r) in enumerate(zip(g_ids, r_ids)):
            if g == r:
                assert g_rows[j][:-1] == r_rows[j][:-1]
                continue
            near = [i for i in range(len(r_d)) if i != j and abs(r_d[i] - r_d[j]) <= tol]
            assert near or j == len(r_d) - 1, (q, j, g, r)
            assert g in r_ids or j == len(r_d) - 1


def test_top_k_ties_go_to_the_lower_index(table, tmp_path, capsys):
    """Rows 3, 17 and 31 hold the same embedding: each one's nearest rows
    are the other two, at distance ~0, the lower index first."""
    src, _ = table
    _, got = _run_both(src, ["--id-column", "rid", "--top-k", "3"], tmp_path, capsys)
    nb = _neighbours(got)
    assert [n for n, _, _ in nb["r3"][:2]] == ["r17", "r31"]
    assert [n for n, _, _ in nb["r17"][:2]] == ["r3", "r31"]
    assert [n for n, _, _ in nb["r31"][:2]] == ["r3", "r17"]
    assert [n for n, _, _ in nb["r25"][:1]] == ["r8"]


def test_int_ids_and_typed_query(tmp_path, capsys):
    """An int id column: ``--query 7`` matches ``7``, written as ``7``; a
    float column matches its text ``2.5``."""
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(9, 16)).astype(np.float32)
    src = str(tmp_path / "int.tsv")
    _write_input(src, list(range(9)), emb, {"w": [str(0.5 * i) for i in range(9)]})
    for extra in (["--id-column", "rid", "--mode", "2", "--query", "7"],
                  ["--id-column", "w", "--keep-cols", "rid,w", "--mode", "2", "--query", "2.5",
                   "--top-k", "3"]):
        ref, got = _run_both(src, extra, tmp_path, capsys)
        assert [g[:-1] for g in got] == [r[:-1] for r in ref]
        assert got[1][0] in ("7", "5")


@pytest.mark.parametrize("extra, match", [
    (["--id-column", "rid", "--keep-cols", "rid,nope"], "Missing columns"),
    (["--id-column", "rid", "--mode", "2"], "--query must be provided"),
    (["--id-column", "rid", "--mode", "2", "--query", "zz"], "No rows where rid == zz"),
    (["--id-column", "rid", "--top-k", "0"], "--top-k must be >= 1"),
    (["--id-column", "rank", "--mode", "2", "--query", "nan"], "No rows where rank == nan"),
    (["--id-column", "rank", "--mode", "2", "--query", "14"], "No rows where rank == 14"),
])
def test_errors_match_jax_cli(table, extra, match, tmp_path):
    src, _ = table
    for main, dev in ((jdist.main, []), (distances.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match=match):
            main(["--input", src, "--output", str(tmp_path / "o.tsv"), *extra, *dev])


def test_no_rows_left_to_search(tmp_path):
    src = str(tmp_path / "one.tsv")
    _write_input(src, ["a", "a"], np.ones((2, 4), np.float32))
    for main, dev in ((jdist.main, []), (distances.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="No non-query rows"):
            main(["--input", src, "--output", str(tmp_path / "o.tsv"), "--id-column", "rid",
                  "--mode", "2", "--query", "a", "--top-k", "1", *dev])


def _parser_of(main):
    """The parser ``main`` builds, caught at its ``parse_args``."""
    caught = {}

    class Caught(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        caught["parser"] = self
        raise Caught

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Caught):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught["parser"]


def test_parser_is_flag_superset_with_same_defaults():
    def options(parser):
        return {opt: a for a in parser._actions for opt in a.option_strings}

    ref, got = options(_parser_of(jdist.main)), options(distances.build_parser())
    assert set(ref) <= set(got)
    for opt, a in ref.items():
        b = got[opt]
        assert (b.default, b.required, b.choices, b.type, b.nargs, b.const) == \
            (a.default, a.required, a.choices, a.type, a.nargs, a.const), opt


def test_pair_distances_and_indices_match_jax():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(30, 128)).astype(np.float32)
    i1, i2 = distances.all_pairs_indices(30)
    j1, j2 = jdist.all_pairs_indices(30)
    np.testing.assert_array_equal(i1, j1)
    np.testing.assert_array_equal(i2, j2)
    got = distances.pair_distances(emb, i1, i2, batch=100, device="cpu")
    ref = jdist.pair_distances(emb, j1, j2, batch=100)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=REL, atol=0)
    assert distances.pair_distances(emb, i1[:0], i2[:0], device="cpu").shape == (0,)


def test_write_tsv_writes_cells_as_pandas(tmp_path):
    """float32 cells as their shortest text, floats as ``repr``, missing
    cells as ``na_rep``: the bytes ``DataFrame.to_csv`` writes."""
    f32 = np.array([1 / 3, 0.1, 3.0, 1e16, 1e-5, -0.0, 123456.78, 2.5e-8, 16777217],
                   np.float32)
    f64 = [0.1, 7.0, 1e16, 1 / 3, None, 2.5, None, -1.0, 3.0]
    text = ["a", None, "b c", "x", "y", "z", "", "q", "w"]
    ints = list(range(9))
    path = tmp_path / "o.tsv"
    write_tsv(str(path), ["f32", "f64", "text", "int"],
              [[a, b, c, d] for a, b, c, d in zip(f32, f64, text, ints)], na_rep="")
    buf = io.StringIO()
    pd.DataFrame({"f32": f32, "f64": np.array([np.nan if v is None else v for v in f64]),
                  "text": [np.nan if v in (None, "") else v for v in text],
                  "int": np.array(ints)}).to_csv(buf, sep="\t", index=False)
    assert path.read_text() == buf.getvalue()
    write_tsv(str(path), ["a", "b"], [{"a": np.float32(0.1), "b": None}])
    assert path.read_text() == "a\tb\n0.1\tNaN\n"
