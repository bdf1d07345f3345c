"""The port's progressive-alignment profile DP (``ops/pairhmm.py``)
against the JAX package's and against a numpy copy of the reference's
float32 DP, on the CPU.

The exact DP must agree bit for bit: the DP matrices of the wavefront on
the same split scores are equal to JAX's and to ``oracle_dp``, and its
op codes, ties included, are equal to JAX's and to ``oracle_walk``.  The
column dot products are the reference's: one rounded multiply and one
rounded add per embedding dim, equal to ``oracle_seq_dot`` bit for bit.
(XLA on the CPU fuses that multiply-add into an FMA, so JAX's own dot
products there may differ from both in the last bit; the op codes are
compared wherever that does not move a path, which holds for every case
below.)  The fast DP on given score matrices is compared the same way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.ops import pairhmm as jph
from ginfinity_tpu_torch.ops import pairhmm as tph

NEG = np.float32(-1e30)


# -- numpy copies of tests/test_profile_exact.py's oracles -----------------


def oracle_seq_dot(muA, muB):
    S = np.zeros((muA.shape[0], muB.shape[0]), np.float32)
    for d in range(muA.shape[1]):
        S = S + muA[:, None, d] * muB[None, :, d]
    return S


def oracle_dp(S, comp, go, ge):
    La, Lb = S.shape
    M = np.full((La + 1, Lb + 1), NEG, np.float32)
    X = np.full((La + 1, Lb + 1), NEG, np.float32)
    Y = np.full((La + 1, Lb + 1), NEG, np.float32)
    M[0, 0] = 0.0
    go32, ge32 = np.float32(go), np.float32(ge)
    for i in range(1, La + 1):
        X[i, 0] = max(np.float32(M[i - 1, 0] + go32), np.float32(X[i - 1, 0] + ge32))
    for j in range(1, Lb + 1):
        Y[0, j] = max(np.float32(M[0, j - 1] + go32), np.float32(Y[0, j - 1] + ge32))
    for d in range(2, La + Lb + 1):
        lo, hi = max(1, d - Lb), min(La, d - 1)
        if lo > hi:
            continue
        i = np.arange(lo, hi + 1)
        j = d - i
        prev = np.maximum(np.maximum(M[i - 1, j - 1], X[i - 1, j - 1]), Y[i - 1, j - 1])
        M[i, j] = (prev + S[i - 1, j - 1]) + comp[i - 1, j - 1]
        X[i, j] = np.maximum(M[i - 1, j] + go32, X[i - 1, j] + ge32)
        Y[i, j] = np.maximum(M[i, j - 1] + go32, Y[i, j - 1] + ge32)
    return M, X, Y


def oracle_walk(M, X, Y, La, Lb):
    i, j = La, Lb
    ops = []
    while i > 0 or j > 0:
        cur, st = -1e31, 0
        if i > 0 and j > 0 and M[i, j] > cur:
            cur, st = M[i, j], 0
        if i > 0 and X[i, j] > cur:
            cur, st = X[i, j], 1
        if j > 0 and Y[i, j] > cur:
            cur, st = Y[i, j], 2
        ops.append(st)
        if st == 0:
            i, j = i - 1, j - 1
        elif st == 1:
            i -= 1
        else:
            j -= 1
    return ops[::-1]


def _comp(stA, stB):
    return np.where((stA[:, None] >= 0.5) == (stB[None, :] >= 0.5),
                    np.float32(0.2), np.float32(0.0))


def _rand_profile(rng, L, d=16):
    mu = rng.standard_normal((L, d)).astype(np.float32)
    mu /= np.linalg.norm(mu, axis=1, keepdims=True) + 1e-8
    stem = (rng.random(L) > 0.5).astype(np.float32)
    return mu, stem


def _tied_profile(rng, L, d=16):
    """Columns from a handful of exact-valued rows: the dots are exact
    and many DP cells tie."""
    rows = np.array([[1, 0], [0, 1], [0.5, 0.5], [0.25, -0.75]], np.float32)
    mu = np.zeros((L, d), np.float32)
    mu[:, :2] = rows[rng.integers(0, 4, L)]
    stem = (rng.random(L) > 0.5).astype(np.float32)
    return mu, stem


def _dense_from_diagonals(Zs, b, La, Lb):
    ii = np.arange(La + 1)[:, None]
    jj = np.arange(Lb + 1)[None, :]
    return np.asarray(Zs)[ii + jj, b, np.broadcast_to(ii, (La + 1, Lb + 1))]


def _same_bits(a, b):
    """Equal where finite, and NEG in the same cells."""
    ma, mb = a > -1e29, b > -1e29
    return np.array_equal(ma, mb) and np.array_equal(a[ma], b[mb])


SHAPES = [(9, 13), (16, 16), (21, 5), (1, 7), (12, 1)]


@pytest.mark.parametrize("go, ge", [(-10.0, -0.5), (-1.0, -0.3), (0.0, 0.0)])
def test_exact_wavefront_bits(go, ge):
    """One batch of mixed shapes: the port's exact wavefront (run at the
    batch's largest lengths) is bit-equal per pair to JAX's
    ``_profile_wavefront_exact`` (run per pair) and to ``oracle_dp``, on
    the oracle's split scores; ge = -0.3 is not representable, so the
    boundary chains must come out of the recurrence."""
    rng = np.random.default_rng(7)
    prof = [(_rand_profile(rng, La), _rand_profile(rng, Lb)) for La, Lb in SHAPES]
    S_l = [oracle_seq_dot(a[0], b[0]) for a, b in prof]
    C_l = [_comp(a[1], b[1]) for a, b in prof]
    B = len(SHAPES)
    P = max(a for a, _ in SHAPES)
    Q = max(b for _, b in SHAPES)
    Sp = np.zeros((B, P, Q), np.float32)
    Cp = np.zeros((B, P, Q), np.float32)
    for k, (S, C) in enumerate(zip(S_l, C_l)):
        Sp[k, : S.shape[0], : S.shape[1]] = S
        Cp[k, : C.shape[0], : C.shape[1]] = C
    l1 = torch.tensor([a for a, _ in SHAPES])
    l2 = torch.tensor([b for _, b in SHAPES])
    Mt, Xt, Yt = tph._dense(tph._profile_states(torch.from_numpy(Sp), l1, l2, go, ge,
                                                torch.from_numpy(Cp)))
    for k, ((La, Lb), S, C) in enumerate(zip(SHAPES, S_l, C_l)):
        oracle = oracle_dp(S, C, go, ge)
        jw = jph._profile_wavefront_exact(
            jnp.asarray(S)[None], jnp.asarray(C)[None], jnp.asarray([La], jnp.int32),
            jnp.asarray([Lb], jnp.int32), jnp.float32(go), jnp.float32(ge))
        for o, j, t in zip(oracle, jw, (Mt, Xt, Yt)):
            got = t[k, : La + 1, : Lb + 1]
            assert _same_bits(got, o)
            assert _same_bits(got, _dense_from_diagonals(j, 0, La, Lb))
    # the port's diagonal form is the JAX layout: [D+1, B, L1+1]
    Md, _, _ = tph._profile_wavefront_exact(torch.from_numpy(Sp), torch.from_numpy(Cp),
                                            l1, l2, go, ge)
    assert tuple(Md.shape) == (P + Q + 1, B, P + 1)


def test_seq_dot_is_the_reference_accumulation():
    """``_seq_dot_scores`` is bit-equal to the sequential float32
    accumulation (one rounded multiply, one rounded add per dim) and
    within 1e-5 of the float64 dot (32 rounded terms of magnitude ~1)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((3, 20, 32)).astype(np.float32)
    B = rng.standard_normal((3, 15, 32)).astype(np.float32)
    got = tph._seq_dot_scores(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    for k in range(3):
        assert np.array_equal(got[k], oracle_seq_dot(A[k], B[k]))
    np.testing.assert_allclose(got, np.einsum("bpd,bqd->bpq", A.astype(np.float64), B),
                               rtol=0, atol=1e-5)


def _exact_cases(rng):
    cases = []
    for La, Lb in ((12, 10), (8, 17), (20, 20), (1, 5)):
        cases.append((_rand_profile(rng, La), _rand_profile(rng, Lb)))
    for La, Lb in ((10, 10), (14, 9), (6, 6)):
        cases.append((_tied_profile(rng, La), _tied_profile(rng, Lb)))
    a = _tied_profile(rng, 11)
    cases.append((a, a))  # a profile against itself
    return cases


@pytest.mark.parametrize("go, ge", [(-10.0, -0.5), (0.0, 0.0)])
def test_exact_ops_match_jax_and_oracle(go, ge):
    """``profile_align_batch_ops_exact`` on one batch of random and tied
    profiles (exact-valued columns, a profile against itself, zero gap
    costs): op codes identical to JAX's and to ``oracle_walk`` over
    ``oracle_dp`` of the reference's dots."""
    rng = np.random.default_rng(11)
    cases = _exact_cases(rng)
    mu = [(a[0], b[0]) for a, b in cases]
    st = [(a[1], b[1]) for a, b in cases]
    got = tph.profile_align_batch_ops_exact(mu, st, go, ge, device="cpu")
    want = jph.profile_align_batch_ops_exact(mu, st, go, ge)
    for (ma, mb), (sa, sb), g, w in zip(mu, st, got, want):
        M, X, Y = oracle_dp(oracle_seq_dot(ma, mb), _comp(sa, sb), go, ge)
        ref = oracle_walk(M, X, Y, ma.shape[0], mb.shape[0])
        assert g.dtype == np.int8
        assert list(g) == ref
        assert list(g) == list(w)


def test_dual_modality_blend():
    """seq_weight 0.3: the scores are (1 - w) * s_struct + w * s_base
    with each term rounded in float32 (the reference's order); ops equal
    to ``oracle_walk`` on that blend and to JAX's, a record without base
    embeddings blended against zeros."""
    rng = np.random.default_rng(4)
    cases, bases = [], []
    for La, Lb in ((9, 12), (15, 7), (10, 10)):
        cases.append((_rand_profile(rng, La), _rand_profile(rng, Lb)))
        bases.append((_rand_profile(rng, La, d=6)[0], _rand_profile(rng, Lb, d=6)[0]))
    bases[1] = (bases[1][0], np.zeros((7, 6), np.float32))
    w = np.float32(0.3)
    mu = [(a[0], b[0]) for a, b in cases]
    st = [(a[1], b[1]) for a, b in cases]
    got = tph.profile_align_batch_ops_exact(mu, st, -10.0, -0.5, base_pairs=bases,
                                            seq_weight=0.3, device="cpu")
    want = jph.profile_align_batch_ops_exact(mu, st, -10.0, -0.5, base_pairs=bases,
                                             seq_weight=0.3)
    for (ma, mb), (sa, sb), (ba, bb), g, jw in zip(mu, st, bases, got, want):
        S = (np.float32(1.0) - w) * oracle_seq_dot(ma, mb) + w * oracle_seq_dot(ba, bb)
        M, X, Y = oracle_dp(S, _comp(sa, sb), -10.0, -0.5)
        assert list(g) == oracle_walk(M, X, Y, ma.shape[0], mb.shape[0])
        assert list(g) == list(jw)


def _score_cases(rng):
    mats = [rng.normal(size=s).astype(np.float32) for s in ((6, 9), (14, 11), (10, 10), (1, 7))]
    mats += [rng.integers(-1, 2, size=s).astype(np.float32) for s in ((8, 8), (5, 12))]
    mats += [np.zeros((6, 6), np.float32), np.full((4, 9), 0.25, np.float32)]
    return mats


@pytest.mark.parametrize("go, ge", [(-3.0, -0.5), (0.0, 0.0), (-1.0, -0.3)])
def test_fast_ops_match_jax(go, ge):
    """``profile_align_batch_ops`` (library mode's DP, and profile mode's
    under GINFINITY_PROFILE_DP=fast) on random, integer-valued, all-zero
    and constant score matrices: op codes identical to JAX's, ties
    included; the dense M/X/Y of ``profile_align_batch`` bit-equal to
    JAX's (its closed-form boundary chains rounded once, as XLA's fused
    multiply-add rounds them), and the codes equal to the host walk over
    them."""
    rng = np.random.default_rng(3)
    mats = _score_cases(rng)
    got = tph.profile_align_batch_ops(mats, go, ge, device="cpu")
    want = jph.profile_align_batch_ops(mats, go, ge)
    dense_t = tph.profile_align_batch(mats, go, ge, device="cpu")
    dense_j = jph.profile_align_batch(mats, go, ge)
    for S, g, w, dt, dj in zip(mats, got, want, dense_t, dense_j):
        assert list(g) == list(w)
        for a, b in zip(dt, dj):
            assert _same_bits(a, np.asarray(b))
        assert list(g) == oracle_walk(*dt, *S.shape)
    M, X, Y = tph.profile_align(mats[1], go, ge, device="cpu")
    assert all(_same_bits(a, b) for a, b in zip((M, X, Y), dense_t[1]))
    # the diagonal form, [D+1, 1, L1+1], as JAX's _profile_wavefront gives it
    S = mats[1]
    n = lambda x: torch.tensor([x])  # noqa: E731
    got = tph._profile_wavefront(torch.from_numpy(S)[None], n(S.shape[0]), n(S.shape[1]), go, ge)
    want = jph._profile_wavefront(jnp.asarray(S)[None], jnp.asarray([S.shape[0]]),
                                  jnp.asarray([S.shape[1]]), jnp.float32(go), jnp.float32(ge))
    for g, w in zip(got, want):
        assert g.shape == w.shape and _same_bits(g.numpy(), np.asarray(w))


def test_value_traceback_priority():
    """Strict-greater priority M, then X, then Y on exact ties, and code 3
    after the walk ends, in the JAX layout [B, L1+L2]."""
    M = np.full((1, 3, 3), np.float32(-1e30), np.float32)
    X, Y = M.copy(), M.copy()
    M[0, 2, 2] = X[0, 2, 2] = Y[0, 2, 2] = 1.0     # tie: M wins
    X[0, 1, 1] = Y[0, 1, 1] = 0.5                   # tie of X and Y: X wins
    Y[0, 0, 1] = 0.0                                # row 0: only Y
    ops = tph._value_traceback(M, X, Y, np.array([2]), np.array([2]))
    assert ops.shape == (1, 4) and ops.dtype == np.int8
    assert list(ops[0]) == [0, 1, 2, 3]
    assert [list(o) for o in tph._forward_ops(ops)] == [[2, 1, 0]]
