"""The port's ``ginfinity-embed-msa`` (``ginfinity_tpu_torch/pipelines/msa.py``)
against the JAX package's, on the CPU: the TSV reader, consistency and
distances, the guide tree, the library scorer, the progressive stage
and the whole CLI.

Tolerances: consistency slabs and distances 1e-5 absolute (float32 sums
in another order); the library scorer 1e-6 (the same float64 sums: equal
in fact); the progressive stage, given the same slabs and tree, writes a
byte-identical ``.aln.tsv``.  The whole CLI writes byte-identical
``.fasta``/``.sto``/``.aln.tsv`` where both sides build the same guide
tree; where float32 noise in D flips a near-tied guide-tree merge (ROADMAP
queue 3, F2), the test shows that the flip is within the noise (a
float64 check of the NJ/UPGMA criterion) and that, given JAX's tree, the
port writes JAX's bytes.  ``expected_scores.tsv`` (sum of S * kept P per
pair) agrees within 1e-4 relative once the cells that one side keeps and
the other drops (a top-k or pmin threshold within float32 noise) are
taken out of the sum, and D agrees within 1e-4 absolute: all posteriors
of a pair share its partition function Z, ~200 for two similar records
(ulp 1.5e-5), so one float32 rounding of Z scales them all alike, and
the JAX package itself sits up to ~3e-5 from float64 there
(tests/test_torch_pairhmm.py holds the posteriors of such a family to a
float64 run); on shared posteriors D agrees within 1e-5
(``test_consistency_matches_jax``)."""

import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.ops import pairhmm as jph
from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu_torch.ops import pairhmm as tph
from ginfinity_tpu_torch.ops.pairhmm import profile_align
from ginfinity_tpu_torch.pipelines import msa as tmsa

TOL = 1e-5
CLI_REL = 1e-4  # the whole CLI: expected scores (relative) and D (absolute)


def _family_tsv(path, n, lmax, d=16, seed=5, structure=False, base=False, noise=0.15):
    """``bench_msa_scale.py::build_family_tsv`` at a small size: one base
    matrix, each record a prefix of it plus 0.15 noise, values rounded to
    4 places; optionally a dot-bracket column and a base-embeddings
    column (L + 2 rows, as the base-embedding CLI writes them)."""
    rng = np.random.default_rng(seed)
    base_len = int(lmax * 0.95)
    basem = rng.normal(size=(base_len, d)).astype(np.float32)
    cols = ["Name", "node_embeddings"] + (["structure"] if structure else []) + (
        ["base_embeddings"] if base else [])
    rows = []
    for k in range(n):
        L = int(rng.integers(int(lmax * 0.8), lmax + 1))
        if L <= base_len:
            emb = basem[:L] + noise * rng.normal(size=(L, d)).astype(np.float32)
        else:
            emb = np.concatenate(
                [basem, noise * rng.normal(size=(L - base_len, d)).astype(np.float32)])
        row = [f"s{k}", json.dumps(emb.round(4).tolist())]
        if structure:
            h = L // 4
            row.append("(" * h + "." * (L - 2 * h) + ")" * h)
        if base:
            row.append(json.dumps(rng.normal(size=(L + 2, 6)).round(3).tolist()))
        rows.append(row)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(cols)
        w.writerows(rows)
    return str(path)


# -- the TSV reader ---------------------------------------------------------


def test_load_tsv_matches_jax(tmp_path, capsys):
    """Records, names typed as pandas types them (an int column reads
    ``7``), skipped rows and their warnings, dot-bracket and paired
    columns, base embeddings trimmed from L + 2 rows or dropped on a
    length mismatch: all as the JAX reader gives them."""
    rng = np.random.default_rng(2)
    m = lambda L, d=4: json.dumps(rng.normal(size=(L, d)).round(3).tolist())  # noqa: E731
    path = tmp_path / "t.tsv"
    rows = [
        ["7", m(5), "((.))", "[4, 3, -1, 1, 0]", m(7, 3)],
        ["12", "not json", ".....", "", ""],
        ["3", "[1.0, 2.0]", "..", "", ""],
        ["5", m(4), "(..)", "", m(4, 3)],
        ["9", m(6), "((..))x", "", m(5, 3)],
        ["11", m(3), "...", "[0, 1]", ""],
    ]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["Name", "node_embeddings", "db", "paired", "base"])
        w.writerows(rows)
    args = (str(path), "Name", "node_embeddings", "db", "paired", "base")
    want = jmsa.load_tsv(*args)
    out_j = capsys.readouterr().out
    got = tmsa.load_tsv(*args)
    out_t = capsys.readouterr().out
    assert out_t == out_j and "Row 1 ('12')" in out_t
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.name, g.dotbracket, g.paired_idx) == (w.name, w.dotbracket, w.paired_idx)
        assert np.array_equal(g.emb, w.emb) and g.emb.dtype == np.float32
        assert (g.base_emb is None) == (w.base_emb is None)
        if w.base_emb is not None:
            assert np.array_equal(g.base_emb, w.base_emb)
    with pytest.raises(ValueError, match="Missing required columns"):
        tmsa.load_tsv(str(path), "id", "node_embeddings")


def test_host_helpers_match_jax():
    """The host numpy helpers equal JAX's: calibration, the row-and-column
    sparsification, the kNN pair cap, the center trim (dot-bracket and
    paired rows re-indexed) and the dot-bracket conversions."""
    rng = np.random.default_rng(4)
    S = rng.uniform(-1, 1, size=(9, 7)).astype(np.float32)
    assert np.array_equal(tmsa.calibrate_log_odds(S, 5.0, 0.3), jmsa.calibrate_log_odds(S, 5.0, 0.3))
    P = rng.random((12, 10)).astype(np.float32)
    assert np.array_equal(tmsa.sparsify_topk_mask(P, 3, 0.05), jmsa.sparsify_topk_mask(P, 3, 0.05))
    embs = [rng.normal(size=(int(rng.integers(8, 14)), 6)).astype(np.float32) for _ in range(9)]
    dbs = ["((((" + "." * (len(e) - 8) + "))))" for e in embs]

    def records(mod):
        out = [mod.SequenceRecord(f"r{i}", e.copy(), dotbracket=db)
               for i, (e, db) in enumerate(zip(embs, dbs))]
        out[3].paired_idx = jmsa._dotbracket_to_pairs(dbs[3])
        return out

    for max_pairs in (0, 12, 30):
        assert tmsa.pairwise_pairs_to_compute(records(tmsa), max_pairs) == \
            jmsa.pairwise_pairs_to_compute(records(jmsa), max_pairs)
    rt, rj = records(tmsa), records(jmsa)
    assert tmsa.apply_center_trim(rt, 0.6) == jmsa.apply_center_trim(rj, 0.6)
    for a, b in zip(rt, rj):
        assert (a.dotbracket, a.paired_idx) == (b.dotbracket, b.paired_idx)
        assert np.array_equal(a.emb, b.emb)
    for db in dbs + ["(([..]))..{.}", ")(("]:
        pairs = tmsa._dotbracket_to_pairs(db)
        assert pairs == jmsa._dotbracket_to_pairs(db)
        assert tmsa._pairs_to_dotbracket(pairs) == jmsa._pairs_to_dotbracket(pairs)


@pytest.mark.parametrize("dp", ["exact", "fast"])
def test_merge_profiles_matches_jax(dp, monkeypatch):
    """``merge_profiles`` (one merge: the exact DP, or the fast DP on
    ``_profile_score_matrix`` under GINFINITY_PROFILE_DP=fast) with base
    embeddings at seq_weight 0.3: the merged profile equals JAX's (chars
    bit for bit, column means within 1e-6); ``_merge_from_dp`` over the
    dense fast DP equals the fast merge."""
    monkeypatch.setenv("GINFINITY_PROFILE_DP", dp)

    def records(mod):
        r = np.random.default_rng(6)
        out = []
        for i, L in enumerate((13, 9, 11)):
            e = r.normal(size=(L, 8)).astype(np.float32)
            out.append(mod.SequenceRecord(f"r{i}", e / np.linalg.norm(e, axis=1, keepdims=True),
                                          dotbracket="((" + "." * (L - 4) + "))",
                                          base_emb=r.normal(size=(L, 4)).astype(np.float32)))
            out[-1].paired_idx = jmsa._dotbracket_to_pairs(out[-1].dotbracket)
        return out

    pj, pt = jmsa.initial_profiles(records(jmsa)), tmsa.initial_profiles(records(tmsa))
    want = jmsa.merge_profiles(jmsa.merge_profiles(pj[0], pj[1], -10.0, -0.5, 0.3), pj[2],
                               -10.0, -0.5, 0.3)
    got = tmsa.merge_profiles(tmsa.merge_profiles(pt[0], pt[1], -10.0, -0.5, 0.3, device="cpu"),
                              pt[2], -10.0, -0.5, 0.3, device="cpu")
    assert got.member_indices == want.member_indices
    for i in want.member_indices:
        assert np.array_equal(got.aligned_chars[i], want.aligned_chars[i])
    for a, b in ((got.mu_struct, want.mu_struct), (got.mu_base, want.mu_base),
                 (got.stem, want.stem)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if dp == "fast":
        dense = profile_align(tmsa._profile_score_matrix(pt[0], pt[1], 0.3), -10.0, -0.5,
                              device="cpu")
        via_dp = tmsa._merge_from_dp(pt[0], pt[1], *dense)
        one = tmsa.merge_profiles(pt[0], pt[1], -10.0, -0.5, 0.3, device="cpu")
        for i in one.member_indices:
            assert np.array_equal(via_dp.aligned_chars[i], one.aligned_chars[i])


# -- consistency and distances ---------------------------------------------


def _random_post(rng, lengths, topk, drop=()):
    post = {}
    N = len(lengths)
    for a in range(N):
        for b in range(a + 1, N):
            if (a, b) in drop:
                continue
            P = rng.random((lengths[a], lengths[b])).astype(np.float32) ** 3
            keep = jmsa.sparsify_topk_mask(P, topk, 1e-4)
            post[(a, b)] = np.where(keep, P, 0.0).astype(np.float32)
    return post


def _to_slabs(post, W, k):
    """Row top-k slabs [T, W, k] of the dict's pairs, in sorted order."""
    pairs = sorted(post)
    v = np.zeros((len(pairs), W, k), np.float32)
    i = np.zeros((len(pairs), W, k), np.int64)
    for t, p in enumerate(pairs):
        P = post[p]
        Pw = np.zeros((W, W), np.float32)
        Pw[: P.shape[0], : P.shape[1]] = P
        idx = np.argsort(-Pw, axis=1, kind="stable")[:, :k]
        v[t] = np.take_along_axis(Pw, idx, axis=1)
        i[t] = idx
    return pairs, v, i


def _dense(v, i, W):
    out = np.zeros(v.shape[:2] + (W,), np.float64)
    t, r, _ = np.indices(v.shape)
    np.add.at(out, (t, r, i), v)
    return out


@pytest.mark.parametrize("rounds", [0, 1, 2])
@pytest.mark.parametrize("drop", [(), ((1, 3), (0, 4))], ids=["all", "dropped"])
def test_consistency_matches_jax(rounds, drop):
    """The port's device rounds on slabs (two batches of pairs) against
    JAX's dict oracle ``consistency_round`` and against JAX's
    ``consistency_rounds_to_distances_from_slabs``: transformed slabs,
    densified, within 1e-5 of both; D within 1e-5 of both and of
    ``build_distance_matrix`` of the oracle."""
    rng = np.random.default_rng(5 + rounds)
    lengths = [7, 11, 9, 8, 12, 10]
    N, W, k = len(lengths), 12, 4
    post = _random_post(rng, lengths, k, drop)
    pairs, v, i = _to_slabs(post, W, k)
    cut = len(pairs) // 2
    chunks = [pairs[:cut], pairs[cut:]]
    D_t, p_t, kv, ki = tmsa.consistency_rounds_to_distances_from_slabs(
        [torch.from_numpy(v[:cut]), torch.from_numpy(v[cut:])],
        [torch.from_numpy(i[:cut]), torch.from_numpy(i[cut:])], chunks, N, k, rounds,
        return_slabs=True)
    D_j, p_j, jv, ji = jmsa.consistency_rounds_to_distances_from_slabs(
        [jnp.asarray(v[:cut]), jnp.asarray(v[cut:])],
        [jnp.asarray(i[:cut], jnp.int32), jnp.asarray(i[cut:], jnp.int32)], chunks, N, W, k,
        rounds, return_slabs=True)
    want = dict(post)
    for _ in range(rounds):
        want = jmsa.consistency_round(want, N, 0.5, k, 1e-4)
    assert p_t == p_j == pairs
    dt = _dense(kv.numpy(), ki.numpy(), W)
    np.testing.assert_allclose(dt, _dense(np.asarray(jv), np.asarray(ji), W), rtol=0, atol=TOL)
    for t, (a, b) in enumerate(pairs):
        la, lb = lengths[a], lengths[b]
        np.testing.assert_allclose(dt[t, :la, :lb], want[(a, b)], rtol=0, atol=TOL)
        assert not dt[t, la:].any() and not dt[t, :, lb:].any()
    np.testing.assert_allclose(D_t, D_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(D_t, jmsa.build_distance_matrix(want, N), rtol=0, atol=TOL)
    assert D_t.dtype == np.float32


def test_consistency_host_oracle_is_jaxs():
    """The port's host ``consistency_round`` (the oracle the tests use)
    and ``sparsify_topk_mask`` equal JAX's."""
    rng = np.random.default_rng(3)
    post = _random_post(rng, [6, 9, 7, 8], 3, ((0, 2),))
    got = tmsa.consistency_round(post, 4, 0.5, 3, 1e-4)
    want = jmsa.consistency_round(post, 4, 0.5, 3, 1e-4)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key])
    assert np.array_equal(tmsa.build_distance_matrix(post, 4),
                          jmsa.build_distance_matrix(post, 4))


# -- guide tree --------------------------------------------------------------


@pytest.mark.parametrize("method", ["nj", "upgma"])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 20])
def test_guide_tree_topology(method, n):
    """The same nested-tuple topology as JAX's ``build_guide_tree`` on a
    random symmetric D (tests/test_msa.py::TestGuideTree's draws), ties
    to the first (a, b) in ascending-id order included (an all-equal D)."""
    rng = np.random.default_rng(n * 7 + (method == "nj"))
    A = rng.random((n, n)).astype(np.float32)
    D = (A + A.T) / 2
    np.fill_diagonal(D, 0.0)
    assert tmsa.build_guide_tree(D, method) == jmsa.build_guide_tree(D, method)
    flat = np.full((n, n), 0.5, np.float32)
    np.fill_diagonal(flat, 0.0)
    assert tmsa.build_guide_tree(flat, method) == jmsa.build_guide_tree(flat, method)


# -- the library scorer and the progressive stage ----------------------------


def _jax_stage(src, alpha, go, topk=20, rounds=1, tree="nj", local=False):
    """JAX's records, slabs (after ``rounds`` consistency rounds), D and
    guide tree for a family TSV."""
    recs = jmsa.load_tsv(src, "Name", "node_embeddings", "structure")
    for r in recs:
        r.emb = jmsa._l2_normalize_rows(r.emb)
    N = len(recs)
    pairs = jmsa.pairwise_pairs_to_compute(recs, 2000)
    lens = np.array([r.emb.shape[0] for r in recs], np.int32)
    Lcap = 32 if lens.max() <= 32 else 64
    embs = np.zeros((N, Lcap, recs[0].emb.shape[1]), np.float32)
    for n, r in enumerate(recs):
        embs[n, : lens[n]] = r.emb
    k = min(topk, Lcap)
    kv, ki, _ = jph._pair_posteriors_from_embs(
        jnp.asarray(embs), jnp.asarray(lens), jnp.asarray([a for a, _ in pairs], jnp.int32),
        jnp.asarray([b for _, b in pairs], jnp.int32), jnp.float32(alpha), jnp.float32(0.0),
        jnp.float32(go), jnp.float32(-0.5), jnp.float32(1e-4), local, k)
    D, lib_pairs, v, i = jmsa.consistency_rounds_to_distances_from_slabs(
        [kv], [ki], [pairs], N, Lcap, k, rounds, return_slabs=True)
    return recs, lib_pairs, np.asarray(v), np.asarray(i), jmsa.build_guide_tree(D, tree)


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    return _family_tsv(tmp_path_factory.mktemp("fam") / "family.tsv", 7, 30, structure=True)


def test_score_matrix_host_matches_jax(family):
    """``PosteriorLibrary._score_matrix_host`` for leaf pairs and for
    merged profiles (gapped columns, several members a side) within 1e-6
    of JAX's, on JAX's own slabs."""
    recs, pairs, v, i, _ = _jax_stage(family, 8.0, -4.0)
    lengths = [r.emb.shape[0] for r in recs]
    jl = jmsa.PosteriorLibrary(pairs, v, i, lengths)
    tl = tmsa.PosteriorLibrary(pairs, v, i, lengths)
    jp, tp = jmsa.initial_profiles(recs), tmsa.initial_profiles(recs)

    def ops(a, b, gapped):
        m = min(a, b)
        head = [1, 2] + [0] * (m - 1) if gapped else [0] * m
        return head + [1] * (a - m) + [2] * (b - m)

    merged = [tuple(mod._merge_from_ops(prof[x], prof[y], ops(lengths[x], lengths[y], g))
                    for x, y, g in ((0, 4, True), (2, 6, False)))
              for prof, mod in ((jp, jmsa), (tp, tmsa))]
    for (A, B), (ja, jb) in (((tp[1], tp[3]), (jp[1], jp[3])),
                             ((tp[5], tp[0]), (jp[5], jp[0])), (merged[1], merged[0])):
        got = tl._score_matrix_host(A, B)
        want = jl._score_matrix_host(ja, jb)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert merged[1][0].mu_struct.shape[0] == max(lengths[0], lengths[4]) + 1


def _write(mod, aln, recs, prefix):
    mod.write_outputs(aln, [r.name for r in recs], str(prefix), {"expected_scores": [[0.0]]})
    return (prefix.parent / f"{prefix.name}.aln.tsv").read_bytes()


@pytest.mark.parametrize("mode", ["library", "profile"])
def test_progressive_stage_matches_jax(family, mode, tmp_path, monkeypatch):
    """Fed JAX's own slabs and guide tree, the port's levelized
    progressive stage (batched DP per level) writes JAX's ``.aln.tsv``
    byte for byte (JAX on its host path, ``GINFINITY_MSA_POOL=0``):
    library mode's host scorer with the fast DP at gap costs 0, profile
    mode's exact DP at -10 / -0.5."""
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    alpha, go = (8.0, -4.0) if mode == "library" else (5.0, -10.0)
    recs, pairs, v, i, tree = _jax_stage(family, alpha, go)
    lengths = [r.emb.shape[0] for r in recs]
    jl = jmsa.PosteriorLibrary(pairs, v, i, lengths)
    tl = tmsa.PosteriorLibrary(pairs, v, i, lengths)
    dgo, dge = (0.0, 0.0) if mode == "library" else (-10.0, -0.5)
    want = jmsa.msa_from_tree(tree, jmsa.initial_profiles(recs), dgo, dge,
                              scorer=jl.score_matrix if mode == "library" else None,
                              library=jl if mode == "library" else None)
    split = {}
    got = tmsa.msa_from_tree(tree, tmsa.initial_profiles(recs), dgo, dge,
                             scorer=tl.score_matrix if mode == "library" else None,
                             device="cpu", split=split)
    assert _write(tmsa, got, recs, tmp_path / "t") == _write(jmsa, want, recs, tmp_path / "j")
    assert split["rounds"] and sum(r[0] for r in split["rounds"]) == len(recs) - 1


@pytest.mark.parametrize("mode", ["library", "profile"])
def test_progressive_stage_pooled_matches_jax(family, mode, tmp_path, monkeypatch):
    """The same stage on both packages' device pools (``GINFINITY_MSA_POOL``
    unset): the library pools scatter JAX's real (off-grid) consistency
    posteriors from the slabs in float32, in update order, and the
    profile pools merge on the device; the port's ``.aln.tsv`` is JAX's
    byte for byte, and the port's pool path is its host path's."""
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    alpha, go = (8.0, -4.0) if mode == "library" else (5.0, -10.0)
    recs, pairs, v, i, tree = _jax_stage(family, alpha, go)
    lengths = [r.emb.shape[0] for r in recs]
    jl = jmsa.PosteriorLibrary(pairs, None, None, lengths,
                               device_slabs=(jnp.asarray(v), jnp.asarray(i)))
    tl = tmsa.PosteriorLibrary(pairs, None, None, lengths,
                               device_slabs=(torch.from_numpy(v), torch.from_numpy(i).long()))
    lib = mode == "library"
    dgo, dge = (0.0, 0.0) if lib else (-10.0, -0.5)
    want = jmsa.msa_from_tree(tree, jmsa.initial_profiles(recs), dgo, dge,
                              scorer=jl.score_matrix if lib else None, library=jl if lib else None)
    split = {}
    got = tmsa.msa_from_tree(tree, tmsa.initial_profiles(recs), dgo, dge,
                             scorer=tl.score_matrix if lib else None, library=tl if lib else None,
                             device="cpu", split=split)
    assert split["path"] == ("library_pool" if lib else "pool")
    assert _write(tmsa, got, recs, tmp_path / "t") == _write(jmsa, want, recs, tmp_path / "j")
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    host = tmsa.msa_from_tree(tree, tmsa.initial_profiles(recs), dgo, dge,
                              scorer=tmsa.PosteriorLibrary(pairs, v, i, lengths).score_matrix
                              if lib else None, device="cpu")
    assert _write(tmsa, host, recs, tmp_path / "h") == _write(tmsa, got, recs, tmp_path / "t")


# -- the whole CLI -------------------------------------------------------------


def _nj_choices(D, method):
    """Per merge of ``build_guide_tree``'s loop (float64): the criterion
    matrix with the pairs already excluded set to +inf, and the chosen
    pair, as cluster-node labels."""
    N = D.shape[0]
    Wm = D.astype(np.float64).copy()
    np.fill_diagonal(Wm, 0.0)
    nodes = list(range(N))
    sizes = np.ones(N)
    out = []
    while len(nodes) > (1 if method == "upgma" else 2):
        m = Wm.shape[0]
        rsum = Wm.sum(axis=1)
        Q = Wm.copy() if method == "upgma" else (m - 2) * Wm - rsum[:, None] - rsum[None, :]
        Q[np.tril_indices(m)] = np.inf
        a, b = divmod(int(np.argmin(Q)), m)
        out.append((Q, list(nodes), (nodes[a], nodes[b])))
        sa, sb = sizes[a], sizes[b]
        row = ((Wm[a] * sa + Wm[b] * sb) / (sa + sb) if method == "upgma"
               else (Wm[a] + Wm[b] - Wm[a, b]) / 2.0)
        keep = np.ones(m, bool)
        keep[[a, b]] = False
        Wm = np.pad(Wm[np.ix_(keep, keep)], ((0, 1), (0, 1)))
        Wm[-1, :-1] = Wm[:-1, -1] = row[keep]
        nodes = [n for k, n in enumerate(nodes) if keep[k]] + [(nodes[a], nodes[b])]
        sizes = np.append(sizes[keep], sa + sb)
    return out


def _assert_flip_is_noise(Dj, Dt, method):
    """Both float32 D agree within 1e-4, and at the first merge where the
    two trees part, JAX's criterion (float64) separates JAX's choice from
    the port's by no more than the D difference can move it: 3 m
    max|Dj - Dt| for NJ (m clusters), max|Dj - Dt| for UPGMA."""
    eps = float(np.abs(Dj.astype(np.float64) - Dt).max())
    assert eps <= CLI_REL
    for (Qj, nodes_j, cj), (_, nodes_t, ct) in zip(_nj_choices(Dj, method),
                                                  _nj_choices(Dt, method)):
        assert nodes_j == nodes_t
        if cj != ct:
            m = len(nodes_j)
            qa = Qj[nodes_j.index(cj[0]), nodes_j.index(cj[1])]
            qb = Qj[nodes_j.index(ct[0]), nodes_j.index(ct[1])]
            bound = (3 * m if method == "nj" else 1) * eps
            assert 0 <= qb - qa <= bound, (qb - qa, bound)
            return qb - qa, bound
    raise AssertionError("the trees differ but every merge agrees")


def _spy(monkeypatch, mod, name, log):
    real = getattr(mod, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        log.append((a, kw, out))
        return out

    monkeypatch.setattr(mod, name, spy)


def _kept_dense(kv, ki, rows, cols):
    kv, ki = np.asarray(kv, np.float64), np.asarray(ki)
    out = np.zeros((kv.shape[0], kv.shape[1], max(cols, int(ki.max()) + 1)))
    t, r, _ = np.indices(kv.shape)
    np.add.at(out, (t, r, ki), kv)
    return out[:, :rows, :cols]


def _assert_expected(dir_j, dir_t, post_j, post_t):
    """``expected_scores.tsv``: the same cells and text form; values within
    1e-4 relative once the cells kept by one side only are taken out."""
    read = lambda d: list(csv.reader(open(os.path.join(d, "expected_scores.tsv")),  # noqa: E731
                                     delimiter="\t"))
    rj, rt = read(dir_j), read(dir_t)
    assert [len(r) for r in rj] == [len(r) for r in rt]
    ej = np.array(rj, np.float64)
    et = np.array(rt, np.float64)
    assert ((ej == 0) == (et == 0)).all()
    assert all(repr(float(x)) == x for r in rt for x in r)
    if not post_t:
        return
    (targs, tkw, (tv, ti, _)), = post_t
    embs, _, ia, ib = (x.numpy() for x in targs[:4])
    W = embs.shape[1]
    (_, _, (jv, ji, _)), = post_j
    Pt = _kept_dense(tv, ti, W, W)
    Pj = _kept_dense(jv, ji, W, W)[: len(ia)]
    cos = lambda e: np.einsum("bld,bmd->blm", e[ia].astype(np.float64),  # noqa: E731
                              e[ib].astype(np.float64))
    S = cos(embs)
    if "base_embs" in tkw:
        has = tkw["has_base"].numpy()
        wb = (tkw["seq_weight"] * has[ia] * has[ib])[:, None, None]
        S = (1 - wb) * S + wb * cos(tkw["base_embs"].numpy())
    flip = (Pt > 0) != (Pj > 0)
    assert flip.sum() <= 0.01 * (Pt > 0).sum() + 1
    corr = (S * (Pt - Pj) * flip).sum(axis=(1, 2))
    diff = et[ia, ib] - ej[ia, ib] - corr
    assert np.all(np.abs(diff) <= CLI_REL * np.maximum(1.0, np.abs(ej[ia, ib]))), diff


def _run_both(argv, tmp_path, monkeypatch, tree_from_jax=None):
    logs = {"jax": ([], []), "torch": ([], [])}
    _spy(monkeypatch, jmsa, "build_guide_tree", logs["jax"][0])
    _spy(monkeypatch, jph, "_pair_posteriors_from_embs", logs["jax"][1])
    _spy(monkeypatch, tmsa, "build_guide_tree", logs["torch"][0])
    _spy(monkeypatch, tph, "_pair_posteriors_from_embs", logs["torch"][1])
    if tree_from_jax is not None:
        monkeypatch.setattr(tmsa, "build_guide_tree", lambda D, method="nj": tree_from_jax)
    out = {}
    for side, main, extra in (("jax", jmsa.main, []), ("torch", tmsa.main, ["--device", "cpu"])):
        if side == "jax" and tree_from_jax is not None:
            continue
        prefix = tmp_path / side / "msa"
        main(argv + ["--out-prefix", str(prefix)] + extra)
        out[side] = prefix
    return out, logs


def _files(prefix):
    return {s: (prefix.parent / f"{prefix.name}{s}").read_bytes()
            for s in (".fasta", ".sto", ".aln.tsv")}


FAMILY = dict(n=7, lmax=30, structure=True, base=True)
NOISY = dict(n=8, lmax=30, noise=0.3)  # near-equal distances: near-tied merges
CLI_CASES = {
    "library": (FAMILY, []),
    "profile": (FAMILY, ["--dp-score", "profile"]),
    "use_local": (FAMILY, ["--use-local"]),
    "seq_weight": (FAMILY, ["--seq-weight", "0.5", "--base-embeds-col", "base_embeddings"]),
    "use_center": (FAMILY, ["--use-center", "0.8"]),
    "max_pairs": (FAMILY, ["--max-pairs", "9"]),
    "upgma": (FAMILY, ["--tree", "upgma"]),
    "rounds0": (FAMILY, ["--consistency-rounds", "0"]),
    "rounds2_profile": (FAMILY, ["--consistency-rounds", "2", "--dp-score", "profile"]),
    "dotbracket_profile": (FAMILY, ["--dotbracket-col", "structure", "--dp-score", "profile"]),
    "dotbracket": (FAMILY, ["--dotbracket-col", "structure"]),
    "dummy": (None, ["--input", "dummy"]),
    "n2": (dict(n=2, lmax=20, seed=9), []),
    # guide trees that float32 noise flips (ROADMAP queue 3, F2)
    "noisy_nj": (dict(NOISY, seed=7), []),
    "noisy_upgma": (dict(NOISY, seed=2), ["--tree", "upgma"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax(case, tmp_path, monkeypatch):
    """The whole CLI, JAX's ``main`` (``GINFINITY_MSA_POOL`` unset: its
    device pools) against the port's on the CPU: a 7-record family (L
    24-30, d 16) with a structure and a base-embeddings column under each
    option; the dummy input; a 2-record family; two noisier 8-record
    families whose guide trees float32 noise flips.  Byte-identical
    ``.fasta``, ``.sto`` and ``.aln.tsv``, or a guide-tree flip within
    float32 noise and JAX's bytes from JAX's tree; ``expected_scores.tsv``
    and D as the module docstring says."""
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    fixture, argv = CLI_CASES[case]
    if fixture is not None:
        argv = ["--input", _family_tsv(tmp_path / "f.tsv", **fixture)] + argv
    out, logs = _run_both(argv, tmp_path, monkeypatch)
    (jD, jtree), = [(a[0], o) for a, _, o in logs["jax"][0]]
    (tD, ttree), = [(a[0], o) for a, _, o in logs["torch"][0]]
    method = "upgma" if "upgma" in argv else "nj"
    _assert_expected(f"{out['jax']}.diagnostics", f"{out['torch']}.diagnostics",
                     logs["jax"][1], logs["torch"][1])
    want = _files(out["jax"])
    got = out["torch"]
    if ttree != jtree:
        _assert_flip_is_noise(jD, tD, method)
        got = _run_both(argv, tmp_path / "jax_tree", monkeypatch, tree_from_jax=jtree)[0]["torch"]
    assert _files(got) == want
    np.testing.assert_allclose(tD, jD, rtol=0, atol=CLI_REL)
    meta = lambda p: json.load(open(f"{p}.diagnostics/run_meta.json"))  # noqa: E731
    assert set(meta(out["jax"])) <= set(meta(out["torch"]))


def test_cli_refusals(tmp_path):
    """``--refine-iters 1`` (ported since) runs and writes its
    ``refinement`` stats; ``--topk 0`` exits as JAX's does; the card is
    never used unasked."""
    src = _family_tsv(tmp_path / "f.tsv", 3, 10)
    base = ["--input", src, "--out-prefix", str(tmp_path / "o" / "msa"), "--device", "cpu"]
    tmsa.main(base + ["--refine-iters", "1"])
    with open(tmp_path / "o" / "msa.diagnostics" / "run_meta.json") as f:
        assert json.load(f)["refinement"]["iters"] == 1
    with pytest.raises(SystemExit, match="--topk must be >= 1"):
        tmsa.main(base + ["--topk", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmsa.main(base[:4])


def test_parser_is_flag_superset():
    """Every flag of the JAX parser, with its default, type, choices and
    destination, plus ``--device``."""
    opts = lambda p: {o: a for a in p._actions for o in a.option_strings}  # noqa: E731
    ref, got = opts(jmsa.build_parser()), opts(tmsa.build_parser())
    assert set(ref) <= set(got) and "--device" in got
    for opt, a in ref.items():
        b = got[opt]
        assert (b.default, b.required, b.choices, b.type, b.nargs, b.const, b.dest) == \
            (a.default, a.required, a.choices, a.type, a.nargs, a.const, a.dest), opt
