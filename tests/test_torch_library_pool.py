"""The port's library pool (``ginfinity_tpu_torch/ops/library_pool.py``) and
library-mode device scorer (``PosteriorLibrary`` in
``pipelines/msa.py``) against the JAX package's, on the CPU (JAX with
``GINFINITY_MSA_POOL`` unset, on the fixtures of its own
``tests/test_library_pool.py``).

Tolerances.  Op codes per level, MSA strings, refinement stats and rows:
identical, between the two pools and against the port's host scorer
(``GINFINITY_MSA_POOL=0``).  The accumulated score matrices: bit-equal
to JAX's on posteriors that are not on a 1/64 grid (both add in update
order onto the carried accumulator, in float32), and within 1e-6 of the
host scorer's float64 sums.  The ordered accumulation the card runs,
run here on the CPU, is bit-equal to ``index_add_`` onto a carried,
non-zero accumulator."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.ops import library_pool as jlp
from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu_torch.ops import library_pool as tlp
from ginfinity_tpu_torch.pipelines import msa as tmsa
from test_torch_msa import _family_tsv


def _random_library(rng, lens, k=5, coverage=1.0, grid=True):
    """``tests/test_library_pool.py::_random_library``; ``grid=False``
    draws float32 posteriors off the 1/64 grid."""
    N = len(lens)
    Lcap = tmsa._round_capacity(max(lens))
    pairs = [(a, b) for a in range(N) for b in range(a + 1, N) if rng.random() < coverage]
    vals = np.zeros((len(pairs), Lcap, k), np.float32)
    idx = np.zeros((len(pairs), Lcap, k), np.int32)
    for t, (a, b) in enumerate(pairs):
        la, lb = lens[a], lens[b]
        v = (rng.integers(0, 64, size=(la, k)).astype(np.float32) / 64.0 if grid
             else rng.random((la, k)).astype(np.float32))
        v *= rng.random(size=(la, k)) < 0.6
        vals[t, :la] = v
        idx[t, :la] = rng.integers(0, lb, size=(la, k))
    return pairs, vals, idx


def _diagonal_library(rng, lens, k=4):
    """Diagonal-dominant slabs on the 1/64 grid (each position's top
    partner its own index), so merges stay near the leaf length and a
    pool does not overflow."""
    n = len(lens)
    Lcap = tmsa._round_capacity(max(lens))
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n) if rng.random() < 0.5]
    vals = np.zeros((len(pairs), Lcap, k), np.float32)
    idx = np.zeros((len(pairs), Lcap, k), np.int32)
    for t, (a, b) in enumerate(pairs):
        la, lb = lens[a], lens[b]
        vals[t, :la, 0] = 48 / 64.0
        idx[t, :la, 0] = np.minimum(np.arange(la), lb - 1)
        vals[t, :la, 1:] = rng.integers(0, 8, size=(la, k - 1)) / 64.0
        idx[t, :la, 1:] = rng.integers(0, lb, size=(la, k - 1))
    return pairs, vals, idx


def _family(rng, n=7, lo=15, hi=30, dim=8):
    """``tests/test_library_pool.py::_family``: (embedding, dot-bracket)."""
    out = []
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        emb = rng.normal(size=(L, dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8
        out.append((emb, "".join(rng.choice(list("().")) for _ in range(L))))
    return out


def _profiles(mod, fam):
    return mod.initial_profiles([mod.SequenceRecord(f"s{i}", e, dotbracket=db)
                                 for i, (e, db) in enumerate(fam)])


def _tree(rng, n):
    D = rng.random((n, n)).astype(np.float32)
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0.0)
    return jmsa.build_guide_tree(D, method="nj")


class _Case:
    """One fixture: both packages' profiles, host and device libraries."""

    def __init__(self, fam, pairs, vals, idx):
        self.fam = fam
        self.lens = [e.shape[0] for e, _ in fam]
        self.names = [f"s{i}" for i in range(len(fam))]
        self.jp, self.tp = _profiles(jmsa, fam), _profiles(tmsa, fam)
        self.j_host = jmsa.PosteriorLibrary(pairs, vals, idx, self.lens)
        self.j_dev = jmsa.PosteriorLibrary(pairs, None, None, self.lens,
                                           device_slabs=(jnp.asarray(vals), jnp.asarray(idx)))
        self.t_host = tmsa.PosteriorLibrary(pairs, vals, idx, self.lens)
        self.t_dev = tmsa.PosteriorLibrary(
            pairs, None, None, self.lens,
            device_slabs=(torch.from_numpy(vals), torch.from_numpy(idx).long()))

    def strings(self, mod, aln):
        return mod.profile_to_msa_strings(aln, self.names)


def _case(seed, n=7, lo=15, hi=30, coverage=1.0, grid=True):
    rng = np.random.default_rng(seed)
    fam = _family(rng, n, lo, hi)
    case = _Case(fam, *_random_library(rng, [e.shape[0] for e, _ in fam], coverage=coverage,
                                       grid=grid))
    return case, _tree(rng, n)


def _spy(monkeypatch, mod, name):
    log = []
    real = getattr(mod, name)

    def spy(*a, **kw):
        log.append(real(*a, **kw))
        return log[-1]

    monkeypatch.setattr(mod, name, spy)
    return log


def _run_all(case, tree, monkeypatch, go=0.0, ge=0.0):
    """JAX's pool, the port's pool and the port's host scorer loop: their
    MSA strings, the pools' per-level outputs and the port's split."""
    jlog = _spy(monkeypatch, jlp, "run_library_pool")
    tlog = _spy(monkeypatch, tmsa, "run_library_pool")
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    j = jmsa.msa_from_tree(tree, case.jp, go, ge, scorer=case.j_dev.score_matrix,
                           library=case.j_dev)
    split = {}
    t = tmsa.msa_from_tree(tree, case.tp, go, ge, scorer=case.t_dev.score_matrix,
                           library=case.t_dev, device="cpu", split=split)
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    h = tmsa.msa_from_tree(tree, case.tp, go, ge, scorer=case.t_host.score_matrix,
                           device="cpu")
    monkeypatch.delenv("GINFINITY_MSA_POOL")
    assert len(jlog) == len(tlog)
    for jout, tout in zip(jlog, tlog):
        assert (jout is None) == (tout is None)
        if jout is not None:
            for a, b in zip(jout[0] + jout[1], tout[0] + tout[1]):
                np.testing.assert_array_equal(b, a)
    return case.strings(jmsa, j), case.strings(tmsa, t), case.strings(tmsa, h), split


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_matches_jax_and_host(seed, monkeypatch):
    case, tree = _case(seed)
    j, t, h, split = _run_all(case, tree, monkeypatch)
    assert t == j == h and split["path"] == "library_pool"
    assert split["pool"]["levels"] == len(split["rounds"])
    # the pool never downloads the host copy of the slabs
    assert case.t_dev._vals is None and case.t_dev._by_pair is None


def test_chain_tree_matches_jax(monkeypatch):
    """A left-deep chain over more than one step group: every level one
    lane, on a diagonal-dominant library that cannot overflow
    (``test_scan_tail_matches_host_scorer_loop``)."""
    rng = np.random.default_rng(61)
    n = 21
    fam = _family(rng, n, 16, 20)
    case = _Case(fam, *_diagonal_library(rng, [e.shape[0] for e, _ in fam]))
    tree = 0
    for t in range(1, n):
        tree = (tree, t)
    j, t, h, split = _run_all(case, tree, monkeypatch, -0.25, -0.125)
    assert t == j == h and split["path"] == "library_pool"
    assert split["pool"]["levels"] == n - 1


def test_nonzero_gap_costs(monkeypatch):
    case, tree = _case(7, n=6)
    j, t, h, split = _run_all(case, tree, monkeypatch, -0.25, -0.125)
    assert t == j == h and split["path"] == "library_pool"


def test_sparse_pair_coverage(monkeypatch):
    """kNN-capped libraries: many merges with no spanning pair."""
    case, tree = _case(11, n=8, coverage=0.3)
    j, t, h, split = _run_all(case, tree, monkeypatch)
    assert t == j == h and split["path"] == "library_pool"


def test_entry_chunking(monkeypatch):
    """Levels with more spanning pairs than one chunk: accumulate-only
    steps carry the accumulator; the same codes as JAX's at the same
    chunk width, and as the host."""
    monkeypatch.setattr(jlp, "_ENTRY_CHUNK", 2)
    monkeypatch.setattr(tlp, "_ENTRY_CHUNK", 2)
    case, tree = _case(13)
    j, t, h, split = _run_all(case, tree, monkeypatch)
    assert t == j == h and split["pool"]["steps"] > split["pool"]["levels"]


def test_wide_family(monkeypatch):
    """24 sequences: wide early levels (several lane groups), chunked
    scatters and a long tail.  The CLI's rungs overflow on this gap-heavy
    random library in both packages (both fall back alike); at P = 128
    both pools run to the end with the same codes per level."""
    case, tree = _case(53, n=24, lo=20, hi=34, coverage=0.5)
    j, t, h, split = _run_all(case, tree, monkeypatch)
    assert t == j == h
    internals = tmsa._walk_internals(tree)
    N = len(case.lens)
    slot = {id(n): N + k for k, n in enumerate(internals)}
    slot_of = lambda n: n if isinstance(n, int) else slot[id(n)]  # noqa: E731
    levels = tmsa._build_levels(internals)
    assert max(len(lv) for lv in levels) > tlp._LIB_BW

    def members_of(node):
        return [node] if isinstance(node, int) else members_of(node[0]) + members_of(node[1])

    sched = tlp.build_library_schedule(levels, slot_of, N, case.t_dev.pairs, N, members_of)
    pa = np.asarray([a for a, _ in case.t_dev.pairs])
    pb = np.asarray([b for _, b in case.t_dev.pairs])
    lens = np.asarray(case.lens)
    got = tlp.run_library_pool(sched, *case.t_dev.device_slabs, pa, pb, lens,
                               len(internals), 128, 0.0, 0.0)
    want = jlp.run_library_pool(sched, *case.j_dev.device_slabs, pa.astype(np.int32),
                                pb.astype(np.int32), lens.astype(np.int32), len(internals),
                                128, 0.0, 0.0)
    assert got is not None and want is not None
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


def test_schedule_matches_jax():
    case, tree = _case(5, n=12, coverage=0.6)
    internals = tmsa._walk_internals(tree)
    N = len(case.lens)
    slot = {id(n): N + k for k, n in enumerate(internals)}
    slot_of = lambda n: n if isinstance(n, int) else slot[id(n)]  # noqa: E731
    levels = tmsa._build_levels(internals)

    def members_of(node):
        return [node] if isinstance(node, int) else members_of(node[0]) + members_of(node[1])

    got = tlp.build_library_schedule(levels, slot_of, N, case.t_dev.pairs, N, members_of)
    want = jlp.build_library_schedule(levels, slot_of, N, case.t_dev.pairs, N, members_of)
    assert len(got) == len(want)
    for (la, ea, ma, sa), (lb, eb, mb, sb) in zip(got, want):
        assert la == lb and ea == eb
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(sa, sb)
    assert sum(len(e) for _, e, _, _ in got) == len(case.t_dev.pairs)


# -- the accumulator -------------------------------------------------------------


def _merged(mod, prof, a, b, go=-0.5, ge=-0.1):
    return mod.merge_profiles(prof[a], prof[b], go, ge, **({"device": "cpu"} if mod is tmsa
                                                           else {}))


def test_ordered_accumulation_equals_index_add():
    """The card's ordered scatter, run on the CPU, against ``index_add_``
    (and ``np.add.at``) onto a carried, non-zero accumulator: repeated
    cells, zero updates, cells no update touches; bit for bit."""
    rng = np.random.default_rng(19)
    for ncell, E in ((1, 50), (37, 1000), (4000, 200000), (5000, 10)):
        S0 = (rng.random(ncell) * 7).astype(np.float32)
        idx = rng.integers(0, ncell, E)
        v = rng.random(E).astype(np.float32) * (rng.random(E) < 0.8)
        want = torch.from_numpy(S0.copy()).index_add_(0, torch.from_numpy(idx),
                                                      torch.from_numpy(v))
        got = torch.from_numpy(S0.copy())
        tlp.ordered_accumulate(got, torch.from_numpy(idx), torch.from_numpy(v))
        assert got.numpy().tobytes() == want.numpy().tobytes()
        ref = S0.copy()
        np.add.at(ref, idx, v)
        assert ref.tobytes() == want.numpy().tobytes()


def test_level_accumulator_bit_equal_to_jax_off_grid(monkeypatch):
    """One level of three merges of merged (gapped) profiles, on
    posteriors off the 1/64 grid, in chunks of 4 entries (the carried
    accumulator): the port's ``_accumulate_device`` equals JAX's bit for
    bit, and the host scorer's float64 sums within 1e-6."""
    monkeypatch.setattr(jlp, "_ENTRY_CHUNK", 4)
    monkeypatch.setattr(tlp, "_ENTRY_CHUNK", 4)
    case, _ = _case(31, n=12, grid=False)
    level = [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11)]
    jm = [(_merged(jmsa, case.jp, a, b), _merged(jmsa, case.jp, c, d)) for a, b, c, d in level]
    tm = [(_merged(tmsa, case.tp, a, b), _merged(tmsa, case.tp, c, d)) for a, b, c, d in level]
    Sj, *jrest = case.j_dev._accumulate_device(jm)
    St, *trest = case.t_dev._accumulate_device(tm)
    assert jrest == trest and St.dtype == torch.float32
    assert St.numpy().tobytes() == np.asarray(Sj).tobytes()
    assert float(St.abs().max()) > 0 and len(np.unique(St.numpy())) > 100
    for lane, (A, B) in enumerate(tm):
        la, lb, dn = trest[0][lane], trest[1][lane], trest[2][lane]
        np.testing.assert_allclose(St[lane, :la, :lb].numpy() / dn,
                                   case.t_host._score_matrix_host(A, B), rtol=0, atol=1e-6)


def test_device_matrix_values():
    case, _ = _case(31, n=4)
    A, B = _merged(tmsa, case.tp, 0, 1), _merged(tmsa, case.tp, 2, 3)
    Sh = case.t_host._score_matrix_host(A, B)
    Sd = case.t_dev.score_matrix(A, B)
    assert Sd.shape == Sh.shape and Sd.dtype == np.float32
    np.testing.assert_allclose(Sd, Sh, rtol=0, atol=1e-6)
    ja, jb = _merged(jmsa, case.jp, 0, 1), _merged(jmsa, case.jp, 2, 3)
    assert Sd.tobytes() == case.j_dev._score_matrix_device(ja, jb).tobytes()
    assert case.t_dev._vals is None


def test_fused_merge_ops(monkeypatch):
    """``merge_ops`` (scatter and DP fused, codes only downloaded) gives
    the host scorer + batched DP's codes and JAX's fused codes."""
    from ginfinity_tpu_torch.ops.pairhmm import profile_align_batch_ops

    case, _ = _case(37, n=4)
    A, B = _merged(tmsa, case.tp, 0, 1), _merged(tmsa, case.tp, 2, 3)
    ja, jb = _merged(jmsa, case.jp, 0, 1), _merged(jmsa, case.jp, 2, 3)
    for go, ge in [(0.0, 0.0), (-0.25, -0.125)]:
        want = profile_align_batch_ops([case.t_host._score_matrix_host(A, B)], go, ge,
                                       device="cpu")[0]
        got = case.t_dev.merge_ops(A, B, go, ge)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, case.j_dev.merge_ops(ja, jb, go, ge))
    assert case.t_host.merge_ops(A, B, 0.0, 0.0) is None  # no device slabs
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    assert case.t_dev.merge_ops(A, B, 0.0, 0.0) is None
    case.t_dev.score_matrix(A, B)
    assert case.t_dev._vals is not None  # the host loop ran (its lazy download)


def test_overflow_takes_the_fused_level_loop(monkeypatch):
    """With the pool failing (as on overflow), each level is scored and
    aligned on the device, fused: the scorer is never called, and the
    result is the host's."""
    monkeypatch.setattr(tmsa, "run_library_pool", lambda *a, **k: None)
    monkeypatch.setattr(jlp, "run_library_pool", lambda *a, **k: None)
    case, tree = _case(43)
    calls = []

    def counting(A, B):
        calls.append(1)
        return case.t_dev.score_matrix(A, B)

    split = {}
    t = tmsa.msa_from_tree(tree, case.tp, 0.0, 0.0, scorer=counting, library=case.t_dev,
                           device="cpu", split=split)
    j = jmsa.msa_from_tree(tree, case.jp, 0.0, 0.0, scorer=case.j_dev.score_matrix,
                           library=case.j_dev)
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    h = tmsa.msa_from_tree(tree, case.tp, 0.0, 0.0, scorer=case.t_host.score_matrix,
                           device="cpu")
    assert case.strings(tmsa, t) == case.strings(tmsa, h) == case.strings(jmsa, j)
    assert not calls and split["path"] == "overflow->host"
    assert [p["P"] for p in split["pool_runs"]] == [64]  # no higher rung to retry
    assert case.t_dev._vals is None


def test_pool_overflow_retries_a_rung_higher(monkeypatch):
    """The first rung overflows (faked): the retry at the next rung runs,
    and the result is still the host's."""
    real = tlp.run_library_pool
    seen = []

    def first_fails(schedule, *a, **k):
        seen.append(a[6])
        return None if len(seen) == 1 else real(schedule, *a, **k)

    monkeypatch.setattr(tmsa, "run_library_pool", first_fails)
    rng = np.random.default_rng(2)
    fam = _family(rng, 7, 90, 100)  # P = 128, the retry rung 192
    case = _Case(fam, *_diagonal_library(rng, [e.shape[0] for e, _ in fam]))
    tree = _tree(rng, 7)
    split = {}
    t = tmsa.msa_from_tree(tree, case.tp, 0.0, 0.0, scorer=case.t_dev.score_matrix,
                           library=case.t_dev, device="cpu", split=split)
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    h = tmsa.msa_from_tree(tree, case.tp, 0.0, 0.0, scorer=case.t_host.score_matrix,
                           device="cpu")
    assert case.strings(tmsa, t) == case.strings(tmsa, h)
    assert split["path"] == "library_pool" and seen[1] > seen[0]


def test_refinement_fused_matches_host_and_jax():
    case, tree = _case(41)
    aln_t = tmsa.msa_from_tree(tree, case.tp, 0.0, 0.0, scorer=case.t_host.score_matrix,
                               device="cpu")
    aln_j = jmsa.msa_from_tree(tree, case.jp, 0.0, 0.0, scorer=case.j_host.score_matrix)
    split = {}
    host, hs = tmsa.iterative_refinement(aln_t, case.tp, 6, np.random.default_rng(3), 0.0,
                                         0.0, scorer=case.t_host.score_matrix, device="cpu")
    dev, ds = tmsa.iterative_refinement(aln_t, case.tp, 6, np.random.default_rng(3), 0.0, 0.0,
                                        scorer=case.t_dev.score_matrix,
                                        merge_ops_fn=case.t_dev.merge_ops, device="cpu",
                                        split=split)
    jdev, js = jmsa.iterative_refinement(aln_j, case.jp, 6, np.random.default_rng(3), 0.0,
                                         0.0, scorer=case.j_dev.score_matrix,
                                         merge_ops_fn=case.j_dev.merge_ops)
    assert hs == ds == js and split["fused"] == 6 and split["score_s"] == 0.0
    assert case.strings(tmsa, host) == case.strings(tmsa, dev) == case.strings(jmsa, jdev)
    assert case.t_dev._vals is None


def test_cli_pool_matches_host_and_jax(tmp_path, monkeypatch):
    """The whole CLI in library mode: the port's pool, its host path and
    JAX's pool write the same ``.fasta``; ``run_meta.json`` names the
    path the progressive stage took and the pool's split."""
    src = _family_tsv(tmp_path / "f.tsv", 6, 40, d=12, seed=23)
    argv = ["--input", src, "--alpha", "5", "--beta", "0", "--consistency-rounds", "1",
            "--dp-score", "library"]

    def run(main, tag, pool, extra=()):
        if pool:
            monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
        else:
            monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
        prefix = tmp_path / tag / "msa"
        main(argv + ["--out-prefix", str(prefix), *extra])
        meta = json.load(open(f"{prefix}.diagnostics/run_meta.json"))
        return (tmp_path / tag / "msa.fasta").read_text(), meta

    pool, meta = run(tmsa.main, "pool", True, ["--device", "cpu"])
    host, hmeta = run(tmsa.main, "host", False, ["--device", "cpu"])
    jax_pool, _ = run(jmsa.main, "jax", True)
    assert pool == host == jax_pool
    assert meta["progressive_path"] == "library_pool" and hmeta["progressive_path"] == "host"
    assert set(meta["progressive_pool"]) == {"P", "enqueue_s", "device_download_s", "levels",
                                             "steps"}
    assert meta["progressive_pool"]["levels"] == meta["progressive_rounds"]
