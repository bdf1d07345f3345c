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
* local mode's first maximum and its all-negative case (empty path).
"""

import numpy as np
import pytest

from ginfinity_tpu.ops.dp import _traceback_global, _traceback_local
from ginfinity_tpu.ops.dp import affine_align_batch as jalign
from ginfinity_tpu.ops.pallas_dp import align_batch_pallas
from ginfinity_tpu_torch.ops import dp
from ginfinity_tpu_torch.ops.dp_wavefront import dp_wavefront

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


CASES = {
    "normal": lambda: _normal(0),
    "normal_small": lambda: _normal(1, n=5, lo=3, hi=8),
    "integer_ties": lambda: _integer(2),
    "rect_3x37_31x4": lambda: _extremes(3),
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
    rectangle equal the JAX wavefront's."""
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
    for k in range(B):
        got = dp._codes_dense(codes[k], L1)
        ref = dp._codes_dense(rcodes[k], L1)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[: l1[k] + 1, : l2[k] + 1],
                                          r[: l1[k] + 1, : l2[k] + 1])


def test_codes_dense_and_traceback_by_hand():
    """A 2x2 pair whose codes are written out: un-shear, then both walks,
    from every cell, against the JAX package's walks."""
    # cells (i, j) of diagonal d = i + j; codes TH | TE << 2 | TF << 3
    TH = np.array([[0, 2, 2], [1, 0, 2], [1, 1, 0]], np.uint8)
    TE = np.array([[0, 0, 0], [0, 0, 0], [0, 1, 0]], np.uint8)
    TF = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 0]], np.uint8)
    L1, L2 = 2, 2
    plane = np.zeros((L1 + L2, L1 + 1), np.uint8)
    for i in range(L1 + 1):
        for j in range(L2 + 1):
            if i + j >= 1:
                plane[i + j - 1, i] = TH[i, j] | (TE[i, j] << 2) | (TF[i, j] << 3)
    th, te, tf = dp._codes_dense(plane, L1)
    np.testing.assert_array_equal(th, TH)
    np.testing.assert_array_equal(te, TE)
    np.testing.assert_array_equal(tf, TF)
    assert dp._traceback_global(th, te, tf, 2, 2) == [(0, 0), (1, 1)]
    # from (2, 1): up with TE = 1 (stay in the gap), up again, then the
    # walk stops on row 0 in the diag state, as the reference's does
    assert dp._traceback_global(th, te, tf, 2, 1) == [(0, None), (1, None)]
    # from (1, 2): left with TF = 1, left again, then stops on column 0
    assert dp._traceback_global(th, te, tf, 1, 2) == [(None, 0), (None, 1)]
    for i in range(L1 + 1):
        for j in range(L2 + 1):
            assert dp._traceback_global(th, te, tf, i, j) == \
                _traceback_global(th, te, tf, i, j)
            assert dp._traceback_local(th, 2, 2, i, j) == \
                _traceback_local(th, None, 2, 2, i, j)
    assert dp._traceback_local(th, 2, 2, 2, 2) == [(0, 0), (1, 1)]
    th_stop = th.copy()
    th_stop[1, 1] = 3
    assert dp._traceback_local(th_stop, 2, 2, 2, 2) == [(1, 1)]
    assert dp._traceback_local(th, 2, 2, 0, 0) == []


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
