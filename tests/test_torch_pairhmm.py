"""The port's pair-HMM posteriors (``ginfinity_tpu_torch/ops/pairhmm.py``)
against the JAX package's and against exact enumeration, on the CPU.

The port keeps float32 states, rounds every add as the JAX package does,
and evaluates each log-sum-exp and ``exp`` in float64, rounded once (so
that the card and the CPU agree to the bit).  Against JAX the remaining
difference is float32 noise: last-bit ``exp``/``log`` differences, which
a rounding of a state of magnitude ``m`` turns into ~ulp(m) of log
space.  Where states stay small (random scores, random embeddings) that
is far below 1e-5; on a family of similar sequences with alpha 8 the
states reach ~200 (ulp 1.5e-5), and both sides sit ~3e-5 from a float64
run: that case is held to the port's own float64 run instead
(``test_posteriors_of_a_family_against_float64``)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.ops import pairhmm as jph
from ginfinity_tpu_torch.ops import pairhmm as tph

TOL = 1e-5


def _jax_slabs_dense(kv, ki, W):
    """Row slabs -> dense [B, rows, W] (float64), whatever the tie order."""
    kv, ki = np.asarray(kv, np.float64), np.asarray(ki)
    out = np.zeros(kv.shape[:2] + (max(W, int(ki.max()) + 1),), np.float64)
    b, r, _ = np.indices(kv.shape)
    np.add.at(out, (b, r, ki), kv)
    return out[:, :, :W]


def test_lse_helpers_match_jax():
    """``_lse2``, ``_lse3`` and ``_lse_masked_rows`` within 1e-6 of JAX's
    on values of magnitude ~50 with NEG entries (float32 ulp at 50 is
    3.8e-6; the port rounds once from float64, JAX after each op): a NEG
    term never moves a result and all-NEG gives NEG exactly."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(scale=50, size=(6, 9)).astype(np.float32) for _ in range(3))
    a[0] = b[0] = c[0] = -1e30
    b[1] = -1e30
    mask = rng.random((6, 9)) > 0.4
    mask[2] = False
    got = [tph._lse2(*map(torch.from_numpy, (a, b))),
           tph._lse3(*map(torch.from_numpy, (a, b, c))),
           tph._lse_masked_rows(torch.from_numpy(a), torch.from_numpy(mask))]
    want = [jph._lse2(a, b), jph._lse3(a, b, c), jph._lse_masked_rows(a, mask)]
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32
        neg = w <= -1e29
        assert np.array_equal(neg, g <= -1e29) and (g[neg] == np.float32(-1e30)).all()
        np.testing.assert_allclose(g[~neg], w[~neg], rtol=0, atol=1e-6 * 50)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_posteriors_match_jax_mixed_shapes(mode):
    """Batched posteriors of mixed shapes (one batch, padded to its
    largest lengths; JAX pads to its capacity ladder) within 1e-5 of
    JAX's ``pairhmm_posteriors``, each pair also equal to its own solo
    run (padding changes no real cell)."""
    rng = np.random.default_rng(11)
    mats = [rng.normal(scale=1.5, size=s).astype(np.float32)
            for s in [(2, 2), (4, 3), (3, 5), (9, 7), (1, 6), (17, 12)]]
    want = jph.pairhmm_posteriors(mats, -3.0, -0.7, mode=mode)
    got = tph.pairhmm_posteriors(mats, -3.0, -0.7, mode=mode, device="cpu")
    for m, g, w in zip(mats, got, want):
        assert g.shape == m.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
        solo = tph.pairhmm_posteriors([m], -3.0, -0.7, mode=mode, device="cpu")[0]
        np.testing.assert_array_equal(g, solo)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_forward_backward_diagonals_match_jax(mode):
    """``_forward`` (M diagonals [D+1, B, L1+1] and Z) and ``_backward``
    (B_M diagonals) in JAX's layout, within 1e-5 of JAX's on every cell
    inside a pair's matrix (states of magnitude < 40 here, ulp < 4e-6),
    NEG on the same cells; padding rows hold -1e4 scores, as JAX pads."""
    rng = np.random.default_rng(3)
    B, L1, L2 = 3, 7, 9
    L = np.full((B, L1, L2), -1e4, np.float32)
    l1 = np.array([7, 4, 6], np.int32)
    l2 = np.array([9, 5, 2], np.int32)
    for k in range(B):
        L[k, : l1[k], : l2[k]] = rng.normal(scale=1.5, size=(l1[k], l2[k]))
    local = mode == "local"
    args = (-3.0, -0.7)
    jM, jZ = jph._forward(jnp.asarray(L), jnp.asarray(l1), jnp.asarray(l2), *args, local=local)
    jB = jph._backward(jnp.asarray(L), jnp.asarray(l1), jnp.asarray(l2), *args, local=local)
    t = [torch.from_numpy(x) for x in (L, l1, l2)]
    tM, tZ = tph._forward(*t, *args, local=local)
    tB = tph._backward(*t, *args, local=local)
    np.testing.assert_allclose(tZ.numpy(), np.asarray(jZ), rtol=0, atol=TOL)
    for got, want in ((tM, jM), (tB, jB)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (L1 + L2 + 1, B, L1 + 1)
        real = want > -1e29
        assert np.array_equal(real, got > -1e29)
        np.testing.assert_allclose(got[real], want[real], rtol=0, atol=TOL)


# -- a copy of the enumeration oracle of tests/test_pairhmm_oracle.py ------


def _gap_cost(length, go, ge):
    return go + ge * (length - 1)


def _enumerate_global(La, Lb):
    def rec(i, j, prev, path):
        if i == La and j == Lb:
            yield list(path)
            return
        if i < La and j < Lb:
            path.append("M")
            yield from rec(i + 1, j + 1, "M", path)
            path.pop()
        if i < La and prev != "Y":
            path.append("X")
            yield from rec(i + 1, j, "X", path)
            path.pop()
        if j < Lb and prev != "X":
            path.append("Y")
            yield from rec(i, j + 1, "Y", path)
            path.pop()

    yield from rec(0, 0, None, [])


def _path_weight(moves, i0, j0, L, go, ge):
    w = 0.0
    i, j = i0, j0
    run = None
    run_len = 0
    for mv in moves:
        if mv == "M":
            if run is not None:
                w += _gap_cost(run_len, go, ge)
                run = None
            w += L[i, j]
            i += 1
            j += 1
        else:
            if run == mv:
                run_len += 1
            else:
                if run is not None:
                    w += _gap_cost(run_len, go, ge)
                run, run_len = mv, 1
            if mv == "X":
                i += 1
            else:
                j += 1
    if run is not None:
        w += _gap_cost(run_len, go, ge)
    return w


def _match_cells(moves, i0, j0):
    cells = []
    i, j = i0, j0
    for mv in moves:
        if mv == "M":
            cells.append((i, j))
            i += 1
            j += 1
        elif mv == "X":
            i += 1
        else:
            j += 1
    return cells


def _oracle_global(L, go, ge):
    La, Lb = L.shape
    num = np.zeros((La, Lb))
    Z = 0.0
    for moves in _enumerate_global(La, Lb):
        w = np.exp(_path_weight(moves, 0, 0, L, go, ge))
        Z += w
        for (i, j) in _match_cells(moves, 0, 0):
            num[i, j] += w
    return num / Z


def _enumerate_local_moves(La, Lb, i0, j0):
    def rec(i, j, prev, path):
        if path and path[-1] == "M":
            yield list(path)
        if i < La and j < Lb:
            path.append("M")
            yield from rec(i + 1, j + 1, "M", path)
            path.pop()
        if path:
            if i < La and prev != "Y":
                path.append("X")
                yield from rec(i + 1, j, "X", path)
                path.pop()
            if j < Lb and prev != "X":
                path.append("Y")
                yield from rec(i, j + 1, "Y", path)
                path.pop()

    yield from rec(i0, j0, None, [])


def _oracle_local(L, go, ge):
    La, Lb = L.shape
    num = np.zeros((La, Lb))
    Z = 0.0
    for i0, j0 in itertools.product(range(La), range(Lb)):
        for moves in _enumerate_local_moves(La, Lb, i0, j0):
            w = np.exp(_path_weight(moves, i0, j0, L, go, ge))
            Z += w
            for (i, j) in _match_cells(moves, i0, j0):
                num[i, j] += w
    return num / Z


@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (4, 4), (5, 3)])
def test_posteriors_match_enumeration(mode, shape):
    """Against the exact posteriors of every alignment in the model's
    path space (float64), within 1e-5: the states stay below ~20 here, so
    float32 rounding moves a posterior by a few 1e-7."""
    rng = np.random.default_rng(sum(shape) * 7 + (mode == "local"))
    L = rng.normal(scale=1.5, size=shape).astype(np.float32)
    go, ge = -2.0, -0.5
    oracle = (_oracle_global if mode == "global" else _oracle_local)(
        L.astype(np.float64), go, ge)
    got = tph.pairhmm_posteriors([L], go, ge, mode=mode, device="cpu")[0]
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)


# -- the embedding-resident posterior stage --------------------------------


def _records(rng, n, lo, hi, d, similar=False):
    base = rng.normal(size=(hi, d)).astype(np.float32)
    out = []
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        e = (base[:L] + 0.3 * rng.normal(size=(L, d)) if similar
             else rng.normal(size=(L, d))).astype(np.float32)
        out.append(e / np.linalg.norm(e, axis=1, keepdims=True))
    return out


def _stage_inputs(embs_list, base_list, Lcap):
    N = len(embs_list)
    d = embs_list[0].shape[1]
    embs = np.zeros((N, Lcap, d), np.float32)
    lens = np.array([e.shape[0] for e in embs_list], np.int32)
    for i, e in enumerate(embs_list):
        embs[i, : e.shape[0]] = e
    base = has = None
    if base_list is not None:
        db = next(b.shape[1] for b in base_list if b is not None)
        base = np.zeros((N, Lcap, db), np.float32)
        has = np.zeros(N, np.float32)
        for i, b in enumerate(base_list):
            if b is not None:
                base[i, : b.shape[0]] = b
                has[i] = 1.0
    return embs, lens, base, has


def _run_stage(embs, lens, base, has, pairs, alpha, go, local, topk, W, dtype=torch.float32,
               sw=0.5):
    ia = torch.tensor([a for a, _ in pairs])
    ib = torch.tensor([b for _, b in pairs])
    kw = {}
    if base is not None:
        kw = {"base_embs": torch.from_numpy(base[:, :W]).to(dtype),
              "has_base": torch.from_numpy(has).to(dtype), "seq_weight": sw}
    kv, ki, ex = tph._pair_posteriors_from_embs(
        torch.from_numpy(embs[:, :W]).to(dtype), torch.from_numpy(lens.astype(np.int64)),
        ia, ib, alpha, 0.0, go, -0.5, 1e-4, local, topk, **kw)
    return kv.numpy(), ki.numpy(), ex.numpy()


CASES = {
    "global": dict(local=False, base=False, topk=4),
    "local": dict(local=True, base=False, topk=4),
    "base": dict(local=False, base=True, topk=4),
    "base_local": dict(local=True, base=True, topk=3),
    "k_at_lcap": dict(local=False, base=False, topk=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_embs_posteriors_match_jax(case):
    """``_pair_posteriors_from_embs`` against JAX on 6 random records of
    length 6-21, d 8, mixed pairs in one batch: densified slabs within
    1e-5 absolute, ``expected`` within 1e-5 relative.  With and without
    base embeddings (one record lacks them: no blend for its pairs), in
    local mode, and with ``topk`` above the capacity (k = Lcap = 32).
    The port runs at width max(lengths, k); JAX at its ladder capacity."""
    c = CASES[case]
    rng = np.random.default_rng(5 + len(case))
    embs_l = _records(rng, 6, 6, 21, 8)
    base_l = None
    if c["base"]:
        base_l = [rng.normal(size=(e.shape[0], 5)).astype(np.float32) for e in embs_l]
        base_l = [b / np.linalg.norm(b, axis=1, keepdims=True) for b in base_l]
        base_l[2] = None
    Lcap = 32  # jax's _round_capacity(21)
    embs, lens, base, has = _stage_inputs(embs_l, base_l, Lcap)
    pairs = [(0, 1), (0, 2), (1, 3), (2, 5), (3, 4), (4, 5), (1, 5)]
    k = min(c["topk"], Lcap)
    W = max(int(lens.max()), k)
    ia = jnp.asarray([a for a, _ in pairs], jnp.int32)
    ib = jnp.asarray([b for _, b in pairs], jnp.int32)
    kw = {}
    if base is not None:
        kw = dict(base_embs=jnp.asarray(base), has_base=jnp.asarray(has),
                  seq_weight=jnp.float32(0.5), use_base=True)
    jv, ji, jex = jph._pair_posteriors_from_embs(
        jnp.asarray(embs), jnp.asarray(lens), ia, ib, jnp.float32(5.0), jnp.float32(0.0),
        jnp.float32(-4.0), jnp.float32(-0.5), jnp.float32(1e-4), c["local"], k, **kw)
    tv, ti, tex = _run_stage(embs, lens, base, has, pairs, 5.0, -4.0, c["local"], k, W)
    assert tv.shape == (len(pairs), W, k) and tv.dtype == np.float32
    dj = _jax_slabs_dense(jv, ji, Lcap)[:, :W, :W]
    dt = _jax_slabs_dense(tv, ti, W)
    assert np.abs(dj[:, W:]).max(initial=0) == 0
    np.testing.assert_allclose(dt, dj, rtol=0, atol=TOL)
    np.testing.assert_allclose(tex, np.asarray(jex), rtol=TOL, atol=0)
    # the row-and-column rule: at most k kept per row and per column
    assert ((dt > 0).sum(axis=2) <= k).all() and ((dt > 0).sum(axis=1) <= k).all()


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_posteriors_of_a_family_against_float64(local):
    """A family of similar sequences at alpha 8 (the CLI's library-mode
    default): states reach ~200, so each float32 rounding of a state
    moves log space by up to ulp(200)/2 = 7.6e-6 on both sides, and both
    sit ~1e-5 (RMS) from exact arithmetic.  Held to the port's own
    float64 run (the same function on float64 inputs): over the cells all
    three runs keep, the port's RMS error is at most 1.5 times JAX's plus
    5e-6; the kept sets differ in at most 1% of the cells (entries on a
    top-k or pmin threshold); ``expected`` is sum(S * kept P) of the
    port's own slabs within 2e-6 relative (float32 sums)."""
    rng = np.random.default_rng(5)
    embs_l = _records(rng, 7, 21, 30, 16, similar=True)
    Lcap = 32
    embs, lens, _, _ = _stage_inputs(embs_l, None, Lcap)
    pairs = [(a, b) for a in range(7) for b in range(a + 1, 7)]
    k, W = 20, 30
    jv, ji, _ = jph._pair_posteriors_from_embs(
        jnp.asarray(embs), jnp.asarray(lens), jnp.asarray([a for a, _ in pairs], jnp.int32),
        jnp.asarray([b for _, b in pairs], jnp.int32), jnp.float32(8.0), jnp.float32(0.0),
        jnp.float32(-4.0), jnp.float32(-0.5), jnp.float32(1e-4), local, k)
    tv, ti, tex = _run_stage(embs, lens, None, None, pairs, 8.0, -4.0, local, k, W)
    xv, xi, _ = _run_stage(embs, lens, None, None, pairs, 8.0, -4.0, local, k, W,
                             dtype=torch.float64)
    dj = _jax_slabs_dense(jv, ji, Lcap)[:, :W, :W]
    dt, dx = _jax_slabs_dense(tv, ti, W), _jax_slabs_dense(xv, xi, W)
    kept = dx > 0
    for d in (dj, dt):
        assert ((d > 0) != kept).sum() <= 0.01 * kept.sum()
    both = kept & (dj > 0) & (dt > 0)
    rms = lambda a, b: np.sqrt(np.mean((a - b) ** 2))  # noqa: E731
    assert rms(dt[both], dx[both]) <= 1.5 * rms(dj[both], dx[both]) + 5e-6
    # expected = sum(S * kept P) of the port's own slabs: a kept-set flip
    # moves it by S * P of the flipped cell, so it is held to its slabs
    S = np.stack([embs[a, :W].astype(np.float64) @ embs[b, :W].astype(np.float64).T
                  for a, b in pairs])
    np.testing.assert_allclose(tex, (S * dt).sum(axis=(1, 2)), rtol=2e-6, atol=0)


def test_the_stage_runs_where_the_tensors_are():
    """No device argument: the stage follows its inputs (CPU here), and
    the batch entry points take ``device`` and refuse the card unasked."""
    rng = np.random.default_rng(1)
    e = _records(rng, 3, 5, 8, 4)
    embs, lens, _, _ = _stage_inputs(e, None, 8)
    kv, _, ex = _run_stage(embs, lens, None, None, [(0, 1), (1, 2)], 5.0, -4.0, False, 3, 8)
    assert kv.shape == (2, 8, 3) and np.isfinite(ex).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tph.pairhmm_posteriors([np.zeros((2, 2), np.float32)], -1.0, -0.5)
