"""The port's MSA refinement (``--refine-iters``) against the JAX
package's, on the CPU: ``sp_score``, ``extract_subprofile``,
``tree_partitions``, ``iterative_refinement`` in both scoring modes and
the whole CLI (mirrors ``tests/test_msa.py::TestRefinement``).

Tolerances.  On shared inputs everything is exact: ``sp_score`` is the
same host numpy in the same op order (bit-equal floats), the
sub-alignments are equal arrays, and a refinement run gives the same
stats and aligned rows (library mode on one numpy ``PosteriorLibrary``
given to both sides, so both DPs see the same score matrices).  The
whole CLI writes byte-identical ``.fasta``/``.sto``/``.aln.tsv`` and the
same ``refinement`` stats, or, where float32 noise in D flips a
near-tied guide-tree merge (ROADMAP queue 3, F2), shows the flip is
within that noise and writes JAX's bytes from JAX's tree
(``tests/test_torch_msa.py::test_cli_matches_jax``)."""

import json

import numpy as np
import pytest
from test_torch_msa import _assert_flip_is_noise, _family_tsv, _files, _run_both

from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu_torch.pipelines import msa as tmsa


def _records(mod, seed, n_seq=5, L=14, d=8, base=False):
    """Records near one base matrix (tests/test_msa.py's toy family), with
    a stem on each end and optional base embeddings."""
    rng = np.random.default_rng(seed)
    base_m = rng.normal(size=(L, d)).astype(np.float32)
    base_m /= np.linalg.norm(base_m, axis=1, keepdims=True)
    out = []
    for k in range(n_seq):
        Lk = L - (k % 3)
        emb = base_m[:Lk] + 0.05 * rng.normal(size=(Lk, d)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        b = rng.normal(size=(Lk, 4)).astype(np.float32) if base else None
        db = "((" + "." * (Lk - 4) + "))"
        out.append(mod.SequenceRecord(f"s{k}", emb, dotbracket=db,
                                      paired_idx=mod._dotbracket_to_pairs(db), base_emb=b))
    return out


def _poor_alignment(mod, profs):
    """Every odd member shifted right by 3 columns (tests/test_msa.py's
    hand-misaligned start), rebuilt by ``extract_subprofile``."""
    n_cols = max(p.mu_struct.shape[0] for p in profs) + 3
    gap = np.uint8(ord("-"))
    aligned = {}
    for m, p in enumerate(profs):
        chars = np.asarray(p.aligned_chars[m])
        head = 3 if m % 2 else 0
        aligned[m] = np.concatenate([np.full(head, gap), chars,
                                     np.full(n_cols - head - chars.size, gap)])
    d = profs[0].mu_struct.shape[1]
    bad = mod.Profile(np.zeros((n_cols, d), np.float32), None, np.zeros(n_cols, np.float32),
                      list(range(len(profs))), aligned)
    return mod.extract_subprofile(bad, list(range(len(profs))), profs)


def _both(seed, **kw):
    pj = jmsa.initial_profiles(_records(jmsa, seed, **kw))
    pt = tmsa.initial_profiles(_records(tmsa, seed, **kw))
    aj = _poor_alignment(jmsa, pj)
    at = _poor_alignment(tmsa, pt)
    _assert_same(at, aj)
    return (pj, aj), (pt, at)


def _assert_same(got, want, arrays=False):
    assert got.member_indices == want.member_indices
    assert len(got.stem) == len(want.stem)
    for m in want.member_indices:
        assert np.array_equal(got.aligned_chars[m], want.aligned_chars[m]), m
    if arrays:
        assert np.array_equal(got.mu_struct, want.mu_struct)
        assert np.array_equal(got.stem, want.stem)
        assert (got.mu_base is None) == (want.mu_base is None)
        if want.mu_base is not None:
            assert np.array_equal(got.mu_base, want.mu_base)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sp_score_bit_equal(seed):
    """The same float on the poor start, on each leaf, and on a two-member
    alignment (one member gapped), with and without the stem term."""
    (pj, aj), (pt, at) = _both(seed)
    assert tmsa.sp_score(at, pt) == jmsa.sp_score(aj, pj)
    assert tmsa.sp_score(at, pt, beta_struct=0.0) == jmsa.sp_score(aj, pj, beta_struct=0.0)
    for k in range(len(pt)):
        assert tmsa.sp_score(pt[k], pt) == jmsa.sp_score(pj[k], pj) == 0.0
    two_j = jmsa.merge_profiles(pj[0], pj[2], -4.0, -0.5)
    two_t = tmsa.merge_profiles(pt[0], pt[2], -4.0, -0.5, device="cpu")
    assert tmsa.sp_score(two_t, pt) == jmsa.sp_score(two_j, pj) != 0.0


@pytest.mark.parametrize("base", [False, True], ids=["struct", "base"])
def test_extract_subprofile_equal(base):
    """Every subset of the poor start's members: equal rows, column means,
    stems and base means; all members keeps every column."""
    (pj, aj), (pt, at) = _both(3, base=base)
    members = list(at.member_indices)
    subsets = [members, [members[2]], members[:2], members[1::2], [members[4], members[0]]]
    for sub in subsets:
        _assert_same(tmsa.extract_subprofile(at, sub, pt),
                     jmsa.extract_subprofile(aj, sub, pj), arrays=True)
    assert len(tmsa.extract_subprofile(at, members, pt).stem) == len(at.stem)


def _random_tree(rng, n):
    nodes = list(range(n))
    while len(nodes) > 1:
        a, b = sorted(rng.choice(len(nodes), size=2, replace=False))
        pair = (nodes[a], nodes[b]) if rng.random() < 0.5 else (nodes[b], nodes[a])
        nodes = [x for k, x in enumerate(nodes) if k not in (a, b)] + [pair]
    return nodes[0]


@pytest.mark.parametrize("seed", range(6))
def test_tree_partitions_equal(seed):
    """Random topologies of 2-12 leaves, plus the chain and balanced trees
    of tests/test_msa.py: the same sets in the same order."""
    rng = np.random.default_rng(seed)
    for n in (2, 3, 4, 7, 12):
        tree = _random_tree(rng, n)
        assert tmsa.tree_partitions(tree, n) == jmsa.tree_partitions(tree, n)
    chain = 0
    for k in range(1, 6):
        chain = (chain, k)
    for tree, n in ((chain, 6), (((0, 1), (2, 3)), 4), ((((0, 1), 2), (3, (4, 5))), 6)):
        assert tmsa.tree_partitions(tree, n) == jmsa.tree_partitions(tree, n)


def _library(seed, lens, k=5):
    """One numpy library for both sides: slabs of each pair with the true
    match (the same position: the records are prefixes of one matrix) in
    slot 0 and random values (tests/test_library_pool.py's) in the rest."""
    rng = np.random.default_rng(seed)
    N, W = len(lens), max(lens)
    pairs = [(a, b) for a in range(N) for b in range(a + 1, N)]
    vals = np.zeros((len(pairs), W, k), np.float32)
    idx = np.zeros((len(pairs), W, k), np.int32)
    for t, (a, b) in enumerate(pairs):
        la, lb = lens[a], lens[b]
        v = rng.integers(0, 32, size=(la, k)).astype(np.float32) / 64.0
        vals[t, :la] = v * (rng.random(size=(la, k)) < 0.6)
        idx[t, :la] = rng.integers(0, lb, size=(la, k))
        true = np.arange(la) < lb
        vals[t, :la, 0] = np.where(true, 0.9, vals[t, :la, 0])
        idx[t, :la, 0] = np.where(true, np.arange(la), idx[t, :la, 0])
    return (jmsa.PosteriorLibrary(pairs, vals, idx, lens),
            tmsa.PosteriorLibrary(pairs, vals, idx, lens))


@pytest.mark.parametrize("min_gain", [0.0, 0.002])
@pytest.mark.parametrize("mode", ["profile", "library"])
def test_iterative_refinement_matches_jax(mode, min_gain):
    """Iterations past the leave-one-out sweep and the guide tree's
    partitions, into the seeded random splits: identical stats (floats
    included) and aligned rows, in profile mode (the exact DP, with base
    embeddings at seq_weight 0.3) and in library mode (the fast DP on one
    shared library's score matrices, gap costs 0)."""
    seq_weight = 0.3 if mode == "profile" else 0.0
    (pj, aj), (pt, at) = _both(4, n_seq=6, base=mode == "profile")
    n = len(pt)
    tree = _random_tree(np.random.default_rng(9), n)
    parts = tmsa.tree_partitions(tree, n)
    iters = n + len(parts) + 6
    go, ge = (-4.0, -0.5) if mode == "profile" else (0.0, 0.0)
    jl, tl = _library(5, [p.mu_struct.shape[0] for p in pt]) if mode == "library" \
        else (None, None)
    want, wstats = jmsa.iterative_refinement(
        aj, pj, iters, np.random.default_rng(11), go, ge, seq_weight=seq_weight,
        scorer=jl.score_matrix if jl else None, partitions=parts, min_gain=min_gain)
    split = {}
    got, gstats = tmsa.iterative_refinement(
        at, pt, iters, np.random.default_rng(11), go, ge, seq_weight=seq_weight,
        scorer=tl.score_matrix if tl else None, partitions=parts, min_gain=min_gain,
        device="cpu", split=split)
    assert gstats == wstats and wstats["iters"] == iters
    assert wstats["accepted"] >= 1 and wstats["sp_final"] > wstats["sp_initial"]
    _assert_same(got, want, arrays=True)
    assert set(split) == {"extract_s", "score_s", "dp_s", "merge_s", "sp_score_s"}


def test_iterative_refinement_trivial_cases():
    """No iterations, or fewer than three members: the input back with
    sp_final = sp_initial, as JAX returns it."""
    (pj, aj), (pt, at) = _both(6)
    for iters in (0, -2):
        got, gs = tmsa.iterative_refinement(at, pt, iters, np.random.default_rng(0),
                                            -4.0, -0.5, device="cpu")
        want, ws = jmsa.iterative_refinement(aj, pj, iters, np.random.default_rng(0),
                                             -4.0, -0.5)
        assert gs == ws and got is at
    two_t = tmsa.merge_profiles(pt[0], pt[1], -4.0, -0.5, device="cpu")
    two_j = jmsa.merge_profiles(pj[0], pj[1], -4.0, -0.5)
    assert tmsa.iterative_refinement(two_t, pt, 5, np.random.default_rng(0), -4.0, -0.5,
                                     device="cpu")[1] == \
        jmsa.iterative_refinement(two_j, pj, 5, np.random.default_rng(0), -4.0, -0.5)[1]


REFINE_CASES = {
    "dummy": (None, ["--input", "dummy"]),
    "library": (dict(n=7, lmax=30, structure=True), ["--dotbracket-col", "structure"]),
    "profile": (dict(n=7, lmax=30, structure=True),
                ["--dotbracket-col", "structure", "--dp-score", "profile"]),
    # noisier families where a realign is accepted at min_gain 0: by
    # 3.05e-5 of 376.4 (library) and 0.046 of 377.1 (profile)
    "noisy_library": (dict(n=6, lmax=24, seed=0, noise=0.3), ["--refine-min-gain", "0"]),
    "noisy_profile": (dict(n=6, lmax=24, seed=3, noise=0.3),
                      ["--refine-min-gain", "0", "--dp-score", "profile"]),
    "profile_upgma": (dict(n=6, lmax=24, seed=11), ["--dp-score", "profile", "--tree", "upgma"]),
}


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_cli_refine_iters_matches_jax(case, tmp_path, monkeypatch):
    """``--refine-iters 4`` through both CLIs (JAX's with its default pool
    setting, the port's on the CPU): identical files and ``refinement``
    stats, or a guide-tree flip within float32 noise and JAX's bytes and
    stats from JAX's tree."""
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    fixture, argv = REFINE_CASES[case]
    if fixture is not None:
        argv = ["--input", _family_tsv(tmp_path / "f.tsv", **fixture)] + argv
    argv = argv + ["--refine-iters", "4"]
    out, logs = _run_both(argv, tmp_path, monkeypatch)
    meta = lambda p: json.load(open(f"{p}.diagnostics/run_meta.json"))  # noqa: E731
    (jD, jtree), = [(a[0], o) for a, _, o in logs["jax"][0]]
    (tD, ttree), = [(a[0], o) for a, _, o in logs["torch"][0]]
    got = out["torch"]
    if ttree != jtree:
        _assert_flip_is_noise(jD, tD, "upgma" if "upgma" in argv else "nj")
        got = _run_both(argv, tmp_path / "jax_tree", monkeypatch, tree_from_jax=jtree)[0]["torch"]
    assert _files(got) == _files(out["jax"])
    want = meta(out["jax"])["refinement"]
    assert meta(got)["refinement"] == want and want["iters"] == 4
    assert want["sp_final"] >= want["sp_initial"]
    assert want["accepted"] == (1 if case.startswith("noisy") else 0)
    assert set(meta(got)["refinement_split_sec"]) >= {"total_s", "dp_s", "sp_score_s"}
