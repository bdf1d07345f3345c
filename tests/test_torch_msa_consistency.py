"""The port's memory-bounded consistency round
(``ginfinity_tpu_torch/pipelines/msa.py``): the memo round while its
estimate fits ``GINFINITY_MSA_DENSE_BUDGET_MB``, the tiled round past it,
held against each other, against a plain loop, and against the JAX
package's tiled round, on the CPU.

Bars:

- tiled and memo rounds: slabs equal bit for bit at one block plan
  (the same float64 products, added in one order), over 2 rounds, with
  blocks cut down to 1-6 pairs and 1-3 products;
- the float64 sums: equal bit for bit to a Python loop that adds each
  pair's products in the order of its intermediates (and not equal to
  the reversed loop, so the order shows);
- the port's tiled round against JAX's tiled round (forced by its
  ``_MEMO_BUDGET_BYTES = 0``, as ``tests/test_msa.py`` forces it): slabs
  and D within 1e-5, ``tests/test_torch_msa.py``'s bars (float32 sums in
  another order);
- the CLI at budget 0 against JAX's ``main`` on its tiled round:
  byte-identical ``.fasta``/``.sto``/``.aln.tsv``, or a guide-tree flip
  within float32 noise (ROADMAP F2) and JAX's bytes from JAX's tree;
- 8 CPU shards of the tiled round equal to one, as a function and
  through the ``--data-parallel`` CLI;
- a few pairs' round alone (``_update_pairs`` on those pairs, as the
  smoke recomputes them on the CPU) equal to the whole round's rows;
- the block planner keeps its blocks within its share of the budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu_torch.parallel import mesh as mesh_mod
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.pipelines import msa as tmsa

from test_torch_msa import (
    TOL,
    _assert_flip_is_noise,
    _dense,
    _family_tsv,
    _files,
    _random_post,
    _run_both,
    _to_slabs,
)

CPU = torch.device("cpu")
ENV = "GINFINITY_MSA_DENSE_BUDGET_MB"


def _slabs(seed=1, N=9, W=128, k=8, drop=0.3):
    """Row slabs of a random pair set (about 70% of all pairs): k distinct
    columns a row within the partner's length, positive values."""
    rng = np.random.default_rng(seed)
    pairs = [(a, b) for a in range(N) for b in range(a + 1, N) if rng.random() > drop]
    lens = rng.integers(W // 2, W + 1, size=N)
    kv = np.zeros((len(pairs), W, k), np.float32)
    ki = np.tile(np.arange(k), (len(pairs), W, 1))
    for t, (a, b) in enumerate(pairs):
        for r in range(lens[a]):
            ki[t, r] = rng.choice(lens[b], size=k, replace=False)
            kv[t, r] = rng.random(k).astype(np.float32) ** 3
    return pairs, N, torch.from_numpy(kv), torch.from_numpy(ki)


def _rounds(monkeypatch, which, kv, ki, pairs, N, rounds=2, k=8, mesh=None):
    """The rounds with the round forced (the memo estimate set to 0 or past
    any budget); the budget, and so the blocks, as the environment says."""
    with monkeypatch.context() as m:
        m.setattr(tmsa, "_memo_consistency_bytes",
                  (lambda *a: 0) if which == "memo" else (lambda *a: 1 << 62))
        out = tmsa._consistency_rounds_on_slabs(kv, ki, pairs, N, rounds, 0.5, 1e-4, k, mesh)
    assert tmsa.last_consistency_round["round"] == which
    return out


@pytest.mark.parametrize("budget_mb,plan", [(1, (1, 1)), (4, (2, 1)), (12, (6, 3))])
def test_tiled_equals_memo(budget_mb, plan, monkeypatch):
    """At W = 128 a budget of 1, 4 or 12 MiB cuts the blocks to 1-6 pairs
    and 1-3 products; both rounds give the same slabs bit for bit, over 2
    rounds, reading slabs in both orientations."""
    pairs, N, kv, ki = _slabs()
    tt, sA, sB, _, _ = tmsa._schedule(pairs, N)
    assert (sA < 0).any() and (sA > 0).any() and (sB < 0).any() and (sB > 0).any()
    monkeypatch.setenv(ENV, str(budget_mb))
    memo = _rounds(monkeypatch, "memo", kv, ki, pairs, N)
    rec = dict(tmsa.last_consistency_round)
    tiled = _rounds(monkeypatch, "tiled", kv, ki, pairs, N)
    assert (rec["pair_block"], rec["product_batch"]) == plan
    assert (tmsa.last_consistency_round["pair_block"],
            tmsa.last_consistency_round["product_batch"]) == plan
    assert rec["products"] == tt.size and rec["budget_bytes"] == budget_mb << 20
    assert not torch.equal(tiled[0], kv)
    for a, b in zip(memo, tiled):
        assert torch.equal(a, b)


def test_round_of_pairs_equals_full_round(monkeypatch):
    """``_update_pairs`` on a few pairs alone (the smoke's check of a few
    pairs on the CPU) gives them the rows the whole round gives them."""
    pairs, N, kv, ki = _slabs(seed=4)
    monkeypatch.setenv(ENV, "12")
    want = _rounds(monkeypatch, "tiled", kv, ki, pairs, N, rounds=1)
    ids = np.array([0, 5, len(pairs) - 1])
    sched = tmsa._schedule(pairs, N)
    got = tmsa._update_pairs(tmsa._Slabs(kv, ki, CPU, memo=False), ids, sched,
                             tmsa._round_consts(sched[4], 0.5, kv.dtype, CPU),
                             float(np.float32(1e-4)), 8, 2)
    for w, g in zip(want, got):
        assert torch.equal(w[torch.from_numpy(ids)], g)


@pytest.mark.parametrize("memo", [True, False], ids=["memo", "tiled"])
def test_pair_sums_in_rank_order(memo):
    """The float64 sums of every pair, in batches of 1, 7 and all the
    products, equal a loop that adds each pair's products (``torch.mm``
    of the oriented float64 blocks) in ascending C, bit for bit; the same
    loop in descending C gives other bits."""
    pairs, N, kv, ki = _slabs(seed=2)
    sched = tmsa._schedule(pairs, N)
    tt, sA, sB, rank, _ = sched
    src = tmsa._Slabs(kv, ki, CPU, memo)
    ids = np.arange(len(pairs))
    got = [tmsa._pair_sums(src, ids, sched, b) for b in (1, 7, tt.size)]
    P64 = tmsa._densify(kv, ki).to(torch.float64)
    block = lambda s: P64[s - 1] if s > 0 else P64[-s - 1].T  # noqa: E731
    fwd, rev = torch.zeros_like(got[0]), torch.zeros_like(got[0])
    for t in ids:
        js = np.nonzero(tt == t)[0]
        assert np.array_equal(rank[js], np.arange(js.size))
        for j in js:
            fwd[t] += torch.mm(block(sA[j]), block(sB[j]))
        for j in js[::-1]:
            rev[t] += torch.mm(block(sA[j]), block(sB[j]))
    for g in got:
        assert torch.equal(g, fwd)
    assert not torch.equal(rev, fwd)


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("drop", [(), ((1, 3), (0, 4))], ids=["all", "dropped"])
def test_tiled_matches_jax_tiled(rounds, drop, monkeypatch):
    """The port's tiled round (budget 0) against JAX's tiled round
    (``_MEMO_BUDGET_BYTES = 0``) on shared slabs, through
    ``consistency_rounds_to_distances_from_slabs``: slabs, densified, and
    D within 1e-5, and both within 1e-5 of JAX's dict oracle."""
    rng = np.random.default_rng(11 + rounds)
    lengths = [7, 11, 9, 8, 12, 10]
    N, W, k = len(lengths), 12, 4
    post = _random_post(rng, lengths, k, drop)
    pairs, v, i = _to_slabs(post, W, k)
    monkeypatch.setenv(ENV, "0")
    monkeypatch.setattr(jmsa, "_MEMO_BUDGET_BYTES", 0)
    D_t, _, kv, ki = tmsa.consistency_rounds_to_distances_from_slabs(
        [torch.from_numpy(v)], [torch.from_numpy(i)], [pairs], N, k, rounds,
        return_slabs=True)
    assert tmsa.last_consistency_round["round"] == "tiled"
    D_j, _, jv, ji = jmsa.consistency_rounds_to_distances_from_slabs(
        [jnp.asarray(v)], [jnp.asarray(i, jnp.int32)], [pairs],
        N, W, k, rounds, return_slabs=True)
    want = dict(post)
    for _ in range(rounds):
        want = jmsa.consistency_round(want, N, 0.5, k, 1e-4)
    dt = _dense(kv.numpy(), ki.numpy(), W)
    np.testing.assert_allclose(dt, _dense(np.asarray(jv), np.asarray(ji), W), rtol=0, atol=TOL)
    for t, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(dt[t, :lengths[a], :lengths[b]], want[(a, b)], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(D_t, D_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(D_t, jmsa.build_distance_matrix(want, N), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["library", "profile"])
def test_cli_tiled_matches_jax(mode, tmp_path, monkeypatch):
    """``--device cpu`` with ``GINFINITY_MSA_DENSE_BUDGET_MB=0`` (the tiled
    round) against JAX's ``main`` on its tiled round, pools on, on the
    7-record family of ``test_cli_matches_jax``: the same files, or F2's
    flip within float32 noise and JAX's bytes from JAX's tree."""
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    monkeypatch.setenv(ENV, "0")
    monkeypatch.setattr(jmsa, "_MEMO_BUDGET_BYTES", 0)
    src = _family_tsv(tmp_path / "f.tsv", n=7, lmax=30, structure=True, base=True)
    argv = ["--input", src, "--dp-score", mode, "--consistency-rounds", "2"]
    out, logs = _run_both(argv, tmp_path, monkeypatch)
    assert tmsa.last_consistency_round["round"] == "tiled"
    assert tmsa.last_consistency_round["pair_block"] == 1
    (jD, jtree), = [(a[0], o) for a, _, o in logs["jax"][0]]
    (tD, ttree), = [(a[0], o) for a, _, o in logs["torch"][0]]
    got = out["torch"]
    if ttree != jtree:
        _assert_flip_is_noise(jD, tD, "nj")
        got = _run_both(argv, tmp_path / "jax_tree", monkeypatch, tree_from_jax=jtree)[0]["torch"]
    assert _files(got) == _files(out["jax"])


def test_sharded_tiled_equals_unsharded(monkeypatch):
    """The tiled round over 8 CPU shards (blocks of 2 pairs) equals the
    unsharded tiled round."""
    pairs, N, kv, ki = _slabs(seed=3)
    monkeypatch.setenv(ENV, "4")
    want = _rounds(monkeypatch, "tiled", kv, ki, pairs, N)
    got = _rounds(monkeypatch, "tiled", kv, ki, pairs, N, mesh=DataMesh([CPU] * 8))
    assert tmsa.last_consistency_round["pair_block"] == 2
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("mode", ["library", "profile"])
def test_cli_data_parallel_tiled(mode, tmp_path, monkeypatch):
    """``--data-parallel`` over 8 CPU shards (``visible_devices`` patched,
    as ``tests/test_torch_mesh.py`` patches it) at budget 0 writes the
    files of the port's unsharded run at budget 0."""
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    monkeypatch.setenv(ENV, "0")
    src = _family_tsv(tmp_path / "f.tsv", n=7, lmax=30, structure=True, base=True)
    argv = ["--input", src, "--dp-score", mode, "--device", "cpu"]
    tmsa.main(argv + ["--out-prefix", str(tmp_path / "one" / "msa")])
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda device: [device] * 8)
    tmsa.main(argv + ["--data-parallel", "--out-prefix", str(tmp_path / "eight" / "msa")])
    assert tmsa.last_consistency_round["round"] == "tiled"
    assert _files(tmp_path / "eight" / "msa") == _files(tmp_path / "one" / "msa")


def test_budget_and_block_plan(monkeypatch):
    """The budget reads JAX's variable (MiB), JAX's 6,144 MiB on the CPU
    when unset.  For widths up to 2,000 and budgets from 1 MiB to 64 GiB,
    the blocks' temporaries stay within a quarter of the budget wherever
    one product fits an eighth of it (else the blocks are 1 and 1); every
    budget of 2 GiB or more gives one plan; the memo estimate counts the
    dense slabs.  At the smoke's long instance (T = 2,000, W = 2,000,
    k = 20) the memo estimate passes an 80 GB card and the tiled one fits
    half of it."""
    monkeypatch.delenv(ENV, raising=False)
    assert tmsa._memo_budget_bytes([CPU]) == 6144 << 20
    monkeypatch.setenv(ENV, "100")
    assert tmsa._memo_budget_bytes([CPU, CPU]) == 100 << 20
    for W in (12, 32, 128, 300, 1536, 2000):
        big = {tmsa._block_plan(W, 2000, 12000, b << 30) for b in (2, 8, 40, 64)}
        assert len(big) == 1
        for budget in [1 << 20, 12 << 20, 300 << 20, 2 << 30, 40 << 30, 64 << 30]:
            p, q = tmsa._block_plan(W, 2000, 12000, budget)
            temps = (p * tmsa._PAIR_TEMP + q * tmsa._PRODUCT_TEMP) * W * W
            if tmsa._PRODUCT_TEMP * W * W <= budget // 8:
                assert temps <= budget // 4
            else:
                assert (p, q) == (1, 1)
            assert 1 <= p <= tmsa._PAIR_BLOCK and 1 <= q <= tmsa._PRODUCT_BATCH
            memo = tmsa._memo_consistency_bytes(2000, W, 20, (p, q))
            assert memo - tmsa._tiled_consistency_bytes(2000, W, 20, (p, q)) == 12 * 2000 * W * W
    plan = tmsa._block_plan(2000, 2000, 12000, 40 << 30)
    assert tmsa._memo_consistency_bytes(2000, 2000, 20, plan) > 80e9
    assert tmsa._tiled_consistency_bytes(2000, 2000, 20, plan) < 40e9
