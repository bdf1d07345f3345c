"""The port's affine-gap DP (``ginfinity_tpu_torch.ops.dp``) against the
JAX package's: ``affine_align_batch(backend="lax")`` and the Pallas
kernel in interpret mode (``align_batch_pallas(interpret=True)``).

On the CPU the port runs its plain wavefront, the version the CUDA
kernel ``csrc/dp_wavefront.cu`` is held against on the card.  Paths
must be identical and scores within 1e-4 (both sides add the same
float32 values in the same order; 0 difference is expected).  The
places where a DP port goes wrong are each given a case:

* tie rules: an integer-valued score matrix makes diag/E/F and
  open/extend ties common, so a tie broken the other way changes a path;
* boundaries: a non-dyadic gap set (-1.5, -0.3) shows a rounding or a
  fused multiply-add in ``go + (k - 1) ge`` in the score's last bits;
* masking: rectangular extremes (3x37, 31x4) padded in one batch;
* long pairs (up to 160 diagonals) for the warp route's score tiles;
* local mode's first maximum and its all-negative case (empty path).

The CUDA kernel's warp route cannot run here; a numpy model of its lane
schedule (``_warp_model``) is held against the plain version instead,
and the traceback is shown to read no code outside each pair's
rectangle, the only cells the kernel specifies.
"""

import numpy as np
import pytest

from ginfinity_tpu.ops.dp import _traceback_global, _traceback_local
from ginfinity_tpu.ops.dp import affine_align_batch as jalign
from ginfinity_tpu.ops.pallas_dp import align_batch_pallas
from ginfinity_tpu_torch.ops import dp
from ginfinity_tpu_torch.ops.dp_wavefront import dp_wavefront, rectangle_mask, route

TOL = 1e-4
GAPS = [(-1.0, -1.0), (-2.0, -0.5), (-10.0, -0.5), (-1.5, -0.3)]
MODES = ["global", "local"]


def _normal(seed, n=6, lo=3, hi=41):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(lo, hi)), int(rng.integers(lo, hi))))
            .astype(np.float32) for _ in range(n)]


def _integer(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-2, 3, size=(int(rng.integers(5, 30)), int(rng.integers(5, 30))))
            .astype(np.float32) for _ in range(4)]


def _extremes(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, 37)).astype(np.float32),
            rng.normal(size=(31, 4)).astype(np.float32)]


def _long(seed):
    """Pairs of 115-160 diagonals: the warp route refills its score tiles
    (32 diagonals each) several times, at a padded L1 that lanes of R = 2
    rows still cover."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(60, 100)).astype(np.float32),
            rng.normal(size=(20, 130)).astype(np.float32),
            rng.integers(-2, 3, size=(45, 70)).astype(np.float32)]


def _tied_maxima():
    """Local mode's equal maxima: cells (2, 5) and (5, 2) of one diagonal
    (rows of different lanes of the warp route at R = 2), and cells (1, 1)
    and (6, 6) of two diagonals; the first maximum is the smallest d, then
    the smallest i."""
    a = np.full((8, 9), -1.0, np.float32)
    a[1, 4] = a[4, 1] = 5.0
    b = np.full((7, 7), -1.0, np.float32)
    b[0, 0] = b[5, 5] = 3.0
    return [a, b]


CASES = {
    "normal": lambda: _normal(0),
    "normal_small": lambda: _normal(1, n=5, lo=3, hi=8),
    "integer_ties": lambda: _integer(2),
    "rect_3x37_31x4": lambda: _extremes(3),
    "tied_maxima": _tied_maxima,
    "long_60x100": lambda: _long(4),
}


def _check(got, ref):
    assert len(got) == len(ref)
    for (gs, gp), (rs, rp) in zip(got, ref):
        assert gp == rp
        assert abs(gs - rs) <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gaps", GAPS, ids=lambda g: f"{g[0]}_{g[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_lax(case, gaps, mode):
    mats = CASES[case]()
    got = dp.affine_align_batch(mats, *gaps, mode=mode, device="cpu")
    _check(got, jalign(mats, *gaps, mode=mode, backend="lax"))


@pytest.mark.parametrize("case", ["normal", "integer_ties", "rect_3x37_31x4"])
@pytest.mark.parametrize("gaps", [GAPS[1], GAPS[3]], ids=lambda g: f"{g[0]}_{g[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(case, gaps, mode):
    mats = CASES[case]()
    got = dp.affine_align_batch(mats, *gaps, mode=mode, device="cpu")
    _check(got, align_batch_pallas(mats, *gaps, mode=mode, interpret=True))


@pytest.mark.parametrize("gaps", GAPS, ids=lambda g: f"{g[0]}_{g[1]}")
def test_local_all_negative_gives_empty_path(gaps):
    mats = [np.full((8, 11), -2.0, np.float32),
            -np.abs(np.random.default_rng(5).normal(size=(6, 9))).astype(np.float32)]
    got = dp.affine_align_batch(mats, *gaps, mode="local", device="cpu")
    assert got == [(0.0, []), (0.0, [])]
    _check(got, jalign(mats, *gaps, mode="local", backend="lax"))


@pytest.mark.parametrize("mode", MODES)
def test_wavefront_outputs_match_jax(mode):
    """best, best cell and the codes of every cell inside each pair's
    rectangle (``i <= l1``, ``j <= l2``, ``i + j >= 1``, on the sheared
    planes) equal the JAX wavefront's."""
    import jax.numpy as jnp

    from ginfinity_tpu.ops.dp import _wavefront
    import torch

    mats = _integer(7) + _normal(8, n=3)
    B = len(mats)
    L1 = max(m.shape[0] for m in mats)
    L2 = max(m.shape[1] for m in mats)
    scores = np.zeros((B, L1, L2), np.float32)
    l1 = np.array([m.shape[0] for m in mats], np.int32)
    l2 = np.array([m.shape[1] for m in mats], np.int32)
    for k, m in enumerate(mats):
        scores[k, : m.shape[0], : m.shape[1]] = m
    rb, rbi, rbj, rcodes = (np.asarray(x) for x in _wavefront(
        jnp.asarray(scores), jnp.asarray(l1), jnp.asarray(l2), -1.5, -0.3, mode))
    best, bi, bj, codes = (x.numpy() for x in dp_wavefront(
        torch.from_numpy(scores), torch.from_numpy(l1), torch.from_numpy(l2),
        -1.5, -0.3, mode))
    np.testing.assert_array_equal(best, rb)
    np.testing.assert_array_equal(bi, rbi)
    np.testing.assert_array_equal(bj, rbj)
    rcodes = np.transpose(rcodes, (1, 0, 2))  # [D, B, I] -> [B, D, I]
    d = np.arange(1, L1 + L2 + 1)[None, :, None]
    i = np.arange(L1 + 1)[None, None, :]
    real = (i <= l1[:, None, None]) & (d - i >= 0) & (d - i <= l2[:, None, None])
    assert codes.shape == rcodes.shape == real.shape and not real.all()
    np.testing.assert_array_equal(codes[real], rcodes[real])


def _shear(TH, TE, TF, L1, L2):
    """Dense TH/TE/TF as a ``[L1 + L2, L1 + 1]`` diagonal code plane,
    cell (i, j) at ``[i + j - 1, i]``; every other byte 0."""
    plane = np.zeros((L1 + L2, L1 + 1), np.uint8)
    for i in range(TH.shape[0]):
        for j in range(TH.shape[1]):
            if i + j >= 1:
                plane[i + j - 1, i] = TH[i, j] | (TE[i, j] << 2) | (TF[i, j] << 3)
    return plane


def test_codes_dense_and_traceback_by_hand():
    """A 2x2 pair whose codes are written out: both walks read the
    sheared plane in place, from every cell, against the JAX package's
    walks on the dense planes."""
    # cells (i, j) of diagonal d = i + j; codes TH | TE << 2 | TF << 3
    TH = np.array([[0, 2, 2], [1, 0, 2], [1, 1, 0]], np.uint8)
    TE = np.array([[0, 0, 0], [0, 0, 0], [0, 1, 0]], np.uint8)
    TF = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 0]], np.uint8)
    L1, L2 = 2, 2
    plane = _shear(TH, TE, TF, L1, L2)
    assert plane[2, 1] == TH[1, 2] | (TF[1, 2] << 3)  # cell (1, 2) of diagonal 3
    assert dp._traceback_global(plane, 2, 2) == [(0, 0), (1, 1)]
    # from (2, 1): up with TE = 1 (stay in the gap), up again, then the
    # walk stops on row 0 in the diag state, as the reference's does
    assert dp._traceback_global(plane, 2, 1) == [(0, None), (1, None)]
    # from (1, 2): left with TF = 1, left again, then stops on column 0
    assert dp._traceback_global(plane, 1, 2) == [(None, 0), (None, 1)]
    for i in range(L1 + 1):
        for j in range(L2 + 1):
            assert dp._traceback_global(plane, i, j) == _traceback_global(TH, TE, TF, i, j)
            assert dp._traceback_local(plane, i, j) == _traceback_local(TH, None, 2, 2, i, j)
    assert dp._traceback_local(plane, 2, 2) == [(0, 0), (1, 1)]
    th_stop = TH.copy()
    th_stop[1, 1] = 3
    assert dp._traceback_local(_shear(th_stop, TE, TF, L1, L2), 2, 2) == [(1, 1)]
    assert dp._traceback_local(plane, 0, 0) == []
    assert dp._cell_codes(np.full_like(plane, 255))(0, 0) == 0  # no diagonal holds (0, 0)


def _dense(plane, L1, L2):
    """A diagonal code plane un-sheared into dense TH/TE/TF ``[L1+1,
    L2+1]``, cell (0, 0) 0: the layout the JAX package's walks read."""
    TH, TE, TF = (np.zeros((L1 + 1, L2 + 1), np.uint8) for _ in range(3))
    for i in range(L1 + 1):
        for j in range(L2 + 1):
            if i + j >= 1:
                c = plane[i + j - 1, i]
                TH[i, j], TE[i, j], TF[i, j] = c & 3, (c >> 2) & 1, (c >> 3) & 1
    return TH, TE, TF


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_walk_in_place_matches_dense_walk(mode, seed):
    """Random code bytes on planes padded past every pair's real sides:
    ``paths_from_codes`` equals the JAX package's walks on the dense
    planes, from (l1, l2) in global mode and from a drawn cell in local
    mode.  Among the pairs: 1 x 1, and all-diagonal pairs whose walks end
    on row 0 and on column 0."""
    rng = np.random.default_rng(seed)
    sides = [(1, 1), (4, 9), (9, 4)] + [tuple(rng.integers(1, 30, size=2)) for _ in range(9)]
    l1 = np.array([a for a, _ in sides], np.int32)
    l2 = np.array([b for _, b in sides], np.int32)
    L1, L2 = int(l1.max()) + 3, int(l2.max()) + 5
    codes = rng.integers(0, 256, size=(len(sides), L1 + L2, L1 + 1), dtype=np.uint8)
    codes[1:3] = 0  # every cell diagonal: the walks run to row 0 and to column 0
    if mode == "global":
        bi, bj = l1, l2
    else:
        bi = np.array([rng.integers(0, a + 1) for a in l1], np.int32)
        bj = np.array([rng.integers(0, b + 1) for b in l2], np.int32)
        bi[:3], bj[:3] = l1[:3], l2[:3]
    got = dp.paths_from_codes(codes, l1, l2, bi, bj, mode)
    for k, (a, b) in enumerate(sides):
        TH, TE, TF = _dense(codes[k], L1, L2)
        if mode == "global":
            want = _traceback_global(TH, TE, TF, int(a), int(b))
        else:
            want = _traceback_local(TH, None, int(a), int(b), int(bi[k]), int(bj[k]))
        assert got[k] == want, k
    assert got[1] == [(k, 5 + k) for k in range(4)]  # 4 x 9: ends on row 0 at (0, 5)
    assert got[2] == [(5 + k, k) for k in range(4)]  # 9 x 4: ends on column 0 at (5, 0)
    assert len(got[0]) <= 1


def test_affine_align_single_pair_and_bad_mode():
    m = _normal(9, n=1)[0]
    assert dp.affine_align(m, -2.0, -0.5, "local", device="cpu") == \
        dp.affine_align_batch([m], -2.0, -0.5, "local", device="cpu")[0]
    with pytest.raises(ValueError):
        dp.affine_align_batch([m], -1.0, -1.0, "semiglobal", device="cpu")


@pytest.mark.parametrize("L1, ok", [(1, True), (384, True), (8287, True), (8288, False)])
def test_kernel_gate(L1, ok):
    assert dp.dp_kernel_ok(L1, 500, "global") is ok
    assert dp.dp_kernel_ok(L1, 500, "local") is ok
    assert not dp.dp_kernel_ok(L1, 500, "semiglobal")


def _plain(mats, gaps, mode):
    """The plain wavefront on a padded batch: the padded scores, its
    ``[best, bi, bj, codes]`` as numpy arrays, and ``l1, l2``."""
    import torch

    scores, l1, l2 = dp.pad_batch(mats)
    out = dp.wavefront_plain(torch.from_numpy(scores), torch.from_numpy(l1),
                             torch.from_numpy(l2), *gaps, mode)
    return scores, [x.numpy() for x in out], l1, l2


@pytest.mark.parametrize("mode", MODES)
def test_traceback_reads_only_real_rectangle(mode):
    """Every code byte outside each pair's rectangle (i > l1, j > l2, or
    d > l1 + l2), overwritten with random bytes, leaves every path as it
    was: the kernel may leave those bytes unwritten."""
    rng = np.random.default_rng(11)
    for case in sorted(CASES):
        for gaps in (GAPS[0], GAPS[3]):
            _, (best, bi, bj, codes), l1, l2 = _plain(CASES[case](), gaps, mode)
            B, D, I = codes.shape
            outside = ~rectangle_mask(l1, l2, I - 1, D - I + 1)
            assert outside.any()
            noisy = codes.copy()
            noisy[outside] = rng.integers(0, 256, size=int(outside.sum()), dtype=np.uint8)
            assert dp.paths_from_codes(noisy, l1, l2, bi, bj, mode) == \
                dp.paths_from_codes(codes, l1, l2, bi, bj, mode)


def _warp_cell(hup, eup, hdiag, hleft, fleft, s, i, j, valid, on_bound, go, ge, local):
    """``dp_cell`` of ``csrc/dp_wavefront.cu`` over arrays of cells, float32."""
    f32 = np.float32
    neg = f32(dp.NEG)
    e_from_h, e_from_e = hup + go, eup + ge
    te = e_from_h < e_from_e
    E = np.where(te, e_from_e, e_from_h)
    f_from_h, f_from_f = hleft + go, fleft + ge
    tf_neg = (neg + go) < (neg + ge)  # TF of (i, 0), from cell (i, -1)
    tf = np.where((j == 0) & (i > 0), tf_neg, f_from_h < f_from_f)
    F = np.where(f_from_h < f_from_f, f_from_f, f_from_h)
    diag = hdiag + s
    take_diag = (diag >= E) & (diag >= F)
    e_ge_f = E >= F
    H = np.where(take_diag, diag, np.where(e_ge_f, E, F))
    th = np.where(take_diag, 0, np.where(e_ge_f, 1, 2))
    if local:
        stop = H <= 0
        H, th = np.where(stop, f32(0), H), np.where(stop, 3, th)
        H, th = np.where(on_bound, f32(0), H), np.where(on_bound, 3, th)
    else:
        def fma(k):  # go + (k - 1) ge rounded once, as __fmaf_rn
            return (np.float64(go) + (k.astype(np.float64) - 1.0) * np.float64(ge)).astype(f32)
        H = np.where(on_bound, np.where(i == 0, fma(j), fma(i)), H)
        th = np.where(on_bound, np.where(i == 0, 2, 1), th)
    E, F = np.where(on_bound, neg, E), np.where(on_bound, neg, F)
    H, E, F = (np.where(valid, x, neg).astype(f32) for x in (H, E, F))
    return H, E, F, (th | (te << 2) | (tf << 3)).astype(np.uint8)


def _warp_model(scores, l1, l2, go, ge, mode, R, junk=np.nan):
    """The warp route of ``csrc/dp_wavefront.cu`` (``dp_warp_kernel<R>``)
    in numpy, one pair (one warp) at a time, indexed as the kernel is:
    arrays ``[32 lanes, R]``, lane ``t`` holding rows ``tR .. tR+R-1``;
    row ``tR - 1``'s H(d-1) and E(d-1) from lane ``t - 1`` (a shuffle up,
    NEG on lane 0) and its H(d-2) carried from the step before; the
    scores read from two tiles of 32 R rows x 32 floats, filled a block
    of 32 diagonals at a time with the rows, the rotation and the copy
    test the kernel uses, two blocks ahead (each copy, those of the two
    blocks past the last diagonal too, is asserted to read a score of
    the pair; cells that are not filled hold ``junk`` times seeded normal
    values, as shared memory holds whatever it held: only interior cells
    may depend on a score); the loop to the pair's own ``l1 + l2``; cells outside the
    pair's rectangle left unmasked (they feed only each other, and the TF
    bit of cell ``(i, 0)``, which the cell function takes as if
    ``(i, -1)`` held NEG); codes stored for rows ``<= l1`` only (the rest stay 0xFF); each lane's first maximum
    under a strict ``>`` in increasing ``i``, then the shuffle-down
    reduction in the ``before`` order."""
    local = mode == "local"
    B, L1, L2 = scores.shape
    assert R % 2 == 0 and 32 * R >= L1 + 1
    f32 = np.float32
    neg = f32(dp.NEG)
    go, ge = f32(go), f32(ge)
    rows = np.arange(32)[:, None] * R + np.arange(R)[None, :]
    codes = np.full((B, L1 + L2, L1 + 1), 0xFF, np.uint8)
    best = np.zeros(B, f32)
    bi = np.zeros(B, np.int32)
    bj = np.zeros(B, np.int32)
    lanes = np.arange(32)

    def above(x):  # __shfl_up_sync(x[:, R-1], 1), NEG on lane 0
        return np.concatenate([[neg], x[:-1, R - 1]]).astype(f32)

    def shifted(first, x):  # row i-1 of each cell: the lane above for r = 0
        return np.concatenate([first[:, None], x[:, :-1]], axis=1)

    W = 32  # diagonals a tile holds (kWarpSteps)

    def load_tile(tile, S, p1, p2, d0):  # warp_load_tile<R>: lane k copies column k
        k = np.arange(W)
        lo, hi = max(1, d0 - p2), min(p1, d0 + W - 2)
        g = lo // R
        while g * R <= hi:
            for r in range(R):
                i, c = g * R + r, d0 - g * R - 1 + k - r
                ok = (i >= lo) & (i <= hi) & (c >= 0) & (c < p2)
                # every copy reads a score of the pair: row i - 1 < l1, column < l2
                assert not ok.any() or (1 <= i <= p1 and (c[ok] < p2).all()), (d0, i)
                tile[i, (k + g) % W] = np.where(ok, S[min(max(i, 1), L1) - 1,
                                                     np.clip(c, 0, L2 - 1)], f32(0))
            g += 1

    for b in range(B):
        p1, p2 = int(l1[b]), int(l2[b])
        S = scores[b]
        tiles = (np.random.default_rng(b).standard_normal((2, 32 * R, W)) * junk).astype(f32)
        load_tile(tiles[0], S, p1, p2, 1)
        load_tile(tiles[1], S, p1, p2, 1 + W)
        h1 = np.where(rows == 0, f32(0), neg).astype(f32)
        h2, e1, f1 = (np.full((32, R), neg, f32) for _ in range(3))
        up_h2 = np.full(32, neg, f32)
        my_v, my_d, my_i = np.zeros(32, f32), np.zeros(32, np.int64), np.zeros(32, np.int64)
        for d in range(1, p1 + p2 + 1):
            blk, dd = divmod(d - 1, W)
            up_h1, up_e1 = above(h1), above(e1)
            s = tiles[blk % 2][rows, (dd + np.arange(32)[:, None]) % W]
            j = d - rows
            valid = (rows <= p1) & (j >= 0) & (j <= p2)
            on_bound = (rows == 0) | (j == 0)
            # cells outside the rectangle are not masked (valid = True)
            H, E, F, code = _warp_cell(shifted(up_h1, h1), shifted(up_e1, e1),
                                       shifted(up_h2, h2), h1, f1, s, rows, j, True,
                                       on_bound, go, ge, local)
            store = rows <= p1
            codes[b, d - 1, rows[store]] = code[store]
            if local:
                for r in range(R):
                    take = valid[:, r] & ~on_bound[:, r] & (H[:, r] > my_v)
                    my_v = np.where(take, H[:, r], my_v)
                    my_d = np.where(take, d, my_d)
                    my_i = np.where(take, rows[:, r], my_i)
            h2, h1, e1, f1, up_h2 = h1, H, E, F, up_h1
            if dd == W - 1 or d == p1 + p2:  # this tile is refilled two blocks ahead
                load_tile(tiles[blk % 2], S, p1, p2, d - dd + 2 * W)
        if not local:
            t, r = divmod(p1, R)
            best[b] = h1[t, r] if p1 + p2 > 0 else neg
            bi[b], bj[b] = p1, p2
            continue
        for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: out-of-range lanes read their own
            src = np.where(lanes + off < 32, lanes + off, lanes)
            v, dd, ii = my_v[src], my_d[src], my_i[src]
            take = (v > my_v) | ((v == my_v) & ((dd < my_d) | ((dd == my_d) & (ii < my_i))))
            my_v, my_d, my_i = (np.where(take, a, c) for a, c in
                                ((v, my_v), (dd, my_d), (ii, my_i)))
        best[b], bi[b], bj[b] = my_v[0], my_i[0], my_d[0] - my_i[0]
    return best, bi, bj, codes


@pytest.mark.parametrize("R, junk", [(2, 10.0), (4, np.nan), ("route", 1e30)],
                         ids=["2", "4", "route"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gaps", [GAPS[1], GAPS[3]], ids=lambda g: f"{g[0]}_{g[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_warp_schedule_model_matches_plain(case, gaps, mode, R, junk):
    """The warp route's lane schedule gives the plain version's best, best
    cell and codes on every pair's rectangle, bit for bit, whatever the
    score tiles hold where they are not filled."""
    scores, (best, bi, bj, codes), l1, l2 = _plain(CASES[case](), gaps, mode)
    if R == "route":
        kind, R = route(scores.shape[1])
        assert kind == "warp"
    got = _warp_model(scores, l1, l2, *gaps, mode, R, junk)
    np.testing.assert_array_equal(got[0], best)
    np.testing.assert_array_equal(got[1], bi)
    np.testing.assert_array_equal(got[2], bj)
    real = rectangle_mask(l1, l2, *scores.shape[1:])
    np.testing.assert_array_equal(got[3][real], codes[real])


@pytest.mark.parametrize("L1, expected", [(1, ("warp", 2)), (300, ("warp", 10)),
                                          (511, ("warp", 16)), (512, ("cta", 0)),
                                          (8287, ("cta", 0))])
def test_warp_route_choice(L1, expected):
    assert route(L1) == expected
