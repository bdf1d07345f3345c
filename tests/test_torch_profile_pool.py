"""The port's profile pool (``ginfinity_tpu_torch/ops/profile_pool.py``) and
its device value traceback (``ops/value_traceback.py``) against the JAX
package's, on the CPU (JAX with ``GINFINITY_MSA_POOL`` unset, as its own
``tests/test_profile_pool.py`` runs it).

Tolerances: none.  The traceback's plain version gives the same codes as
the host walk and as JAX's ``_value_traceback`` on the same states.  The
pools give identical op codes and lengths per level and identical MSA
strings on the fixtures of ``tests/test_profile_pool.py``, and the
port's pool the same strings as its own host path
(``GINFINITY_MSA_POOL=0``).  The two pools' merged profiles may part by
an ulp (JAX's row norms and its FMA-contracted column dots round
otherwise than the port's sequential float32 sums), which moves no code
on these fixtures."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.ops import pairhmm as jph
from ginfinity_tpu.ops import profile_pool as jpp
from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu_torch.ops import pairhmm as tph
from ginfinity_tpu_torch.ops import profile_pool as tpp
from ginfinity_tpu_torch.ops.value_traceback import value_traceback, value_traceback_plain
from ginfinity_tpu_torch.pipelines import msa as tmsa

# -- the value traceback -------------------------------------------------------


def _states(rng, B, L1, L2, ties, exact=False):
    S = rng.normal(size=(B, L1, L2)).astype(np.float32)
    if ties:  # integer scores and gaps: equal paths everywhere
        S = np.round(S * 2).astype(np.float32)
    l1 = rng.integers(0, L1 + 1, B)
    l2 = rng.integers(0, L2 + 1, B)
    l1[0], l2[0] = L1, L2
    go, ge = (-2.0, -1.0) if ties else (-1.3, -0.4)
    C = (np.round(rng.random((B, L1, L2))) * np.float32(0.2)).astype(np.float32) if exact \
        else None
    t = torch.from_numpy
    ST = tph._profile_states(t(S), t(l1), t(l2), go, ge, None if C is None else t(C))
    return S, C, l1, l2, go, ge, ST


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_traceback_matches_host_walk_and_jax(ties, exact):
    rng = np.random.default_rng(3 + ties + 2 * exact)
    S, C, l1, l2, go, ge, ST = _states(rng, 9, 23, 17, ties, exact)
    got = value_traceback_plain(ST, torch.from_numpy(l1), torch.from_numpy(l2)).numpy()
    M, X, Y = tph._dense(ST)
    assert got.dtype == np.int8 and got.shape == (9, 40)
    np.testing.assert_array_equal(got, tph._value_traceback(M, X, Y, l1, l2))
    want = np.asarray(jph._value_traceback(jnp.asarray(M), jnp.asarray(X), jnp.asarray(Y),
                                           jnp.asarray(l1, jnp.int32),
                                           jnp.asarray(l2, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    if ties:  # the fixture must hold ties that the priority decides
        assert ((M == X) & (M > -1e29)).any()
    # CPU tensors take the plain version; other devices raise
    assert torch.equal(value_traceback(ST, torch.from_numpy(l1), torch.from_numpy(l2)),
                       torch.from_numpy(got))
    with pytest.raises(ValueError, match="unsupported device"):
        value_traceback(ST.to("meta"), torch.from_numpy(l1).to("meta"),
                        torch.from_numpy(l2).to("meta"))


def test_device_ops_match_jax_impl():
    """``_profile_ops_device`` (fast DP) and ``_profile_ops_exact_device``
    (integer-valued embeddings: exact dots on both sides) against JAX's
    ``_profile_ops_impl`` and ``_profile_ops_exact_impl``: codes [B, 2P]."""
    rng = np.random.default_rng(11)
    B, P, d = 6, 20, 5
    S = np.round(rng.normal(size=(B, P, P)) * 3).astype(np.float32) / 4
    l1 = rng.integers(1, P + 1, B)
    l2 = rng.integers(1, P + 1, B)
    t, j = torch.from_numpy, jnp.asarray
    got = tph._profile_ops_device(t(S), t(l1), t(l2), -0.5, -0.25).numpy()
    want = jph._profile_ops_impl(j(S), j(l1, jnp.int32), j(l2, jnp.int32), jnp.float32(-0.5),
                                 jnp.float32(-0.25))
    np.testing.assert_array_equal(got, np.asarray(want))
    mua = rng.integers(-2, 3, (B, P, d)).astype(np.float32)
    mub = rng.integers(-2, 3, (B, P, d)).astype(np.float32)
    sta = rng.integers(0, 2, (B, P)).astype(np.float32)
    stb = rng.integers(0, 2, (B, P)).astype(np.float32)
    got = tph._profile_ops_exact_device(t(mua), t(mub), t(sta), t(stb), t(l1), t(l2),
                                        -3.0, -0.5).numpy()
    want = jph._profile_ops_exact_impl(j(mua), j(mub), j(sta), j(stb), j(l1, jnp.int32),
                                       j(l2, jnp.int32), jnp.float32(-3.0), jnp.float32(-0.5))
    np.testing.assert_array_equal(got, np.asarray(want))


# -- the pool ----------------------------------------------------------------


def _family(rng, n, lmax, d=8, noise=0.2, base_dim=0):
    """``tests/test_profile_pool.py::_family`` (plus base embeddings), as
    arrays both packages' records are built from."""
    base = rng.normal(size=(lmax, d)).astype(np.float32)
    out = []
    for _ in range(n):
        L = int(rng.integers(int(lmax * 0.7), lmax + 1))
        e = base[:L] + noise * rng.normal(size=(L, d)).astype(np.float32)
        b = rng.normal(size=(L, base_dim)).astype(np.float32) if base_dim else None
        out.append((jmsa._l2_normalize_rows(e), None if b is None else jmsa._l2_normalize_rows(b)))
    return out


def _profiles(mod, fam):
    return mod.initial_profiles([mod.SequenceRecord(f"s{k}", e, base_emb=b)
                                 for k, (e, b) in enumerate(fam)])


def _nj_tree(seed, n):
    rng = np.random.default_rng(seed)
    D = rng.random((n, n))
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0)
    return jmsa.build_guide_tree(D)


def _spy(monkeypatch, mod, name):
    log = []
    real = getattr(mod, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        log.append(out)
        return out

    monkeypatch.setattr(mod, name, spy)
    return log


def _run_all(fam, tree, monkeypatch, go=-1.0, ge=-0.1, sw=0.0):
    """JAX's pool, the port's pool and the port's host path on one tree:
    their MSA strings, the pools' per-level outputs and the port's split."""
    names = [f"s{k}" for k in range(len(fam))]
    jlog = _spy(monkeypatch, jpp, "run_progressive_pool")
    tlog = _spy(monkeypatch, tmsa, "run_progressive_pool")
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    jaln = jmsa.msa_from_tree(tree, _profiles(jmsa, fam), go, ge, sw)
    split = {}
    taln = tmsa.msa_from_tree(tree, _profiles(tmsa, fam), go, ge, sw, device="cpu", split=split)
    monkeypatch.setenv("GINFINITY_MSA_POOL", "0")
    host = tmsa.msa_from_tree(tree, _profiles(tmsa, fam), go, ge, sw, device="cpu")
    monkeypatch.delenv("GINFINITY_MSA_POOL")
    strings = [m.profile_to_msa_strings(a, names)
               for m, a in ((jmsa, jaln), (tmsa, taln), (tmsa, host))]
    return strings, jlog, tlog, split


def _assert_same_levels(jlog, tlog):
    (jout,), (tout,) = jlog, tlog
    assert (jout is None) == (tout is None)
    if jout is None:
        return 0
    for (jo, jl), (to, tl) in zip(zip(*jout), zip(*tout)):
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tl, jl)
    assert len(jout[0]) == len(tout[0])
    return len(tout[0])


@pytest.mark.parametrize("n,lmax,seed", [(6, 12, 0), (10, 25, 1), (18, 40, 2), (30, 35, 3)])
def test_pool_matches_jax_and_host(n, lmax, seed, monkeypatch):
    fam = _family(np.random.default_rng(seed + 100), n, lmax)
    (j, t, h), jlog, tlog, split = _run_all(fam, _nj_tree(seed, n), monkeypatch)
    assert t == j and t == h
    assert _assert_same_levels(jlog, tlog) == split["pool"]["levels"]
    assert split["path"] == "pool"
    assert split["pool"]["P"] == jpp.pool_padded_len(max(e.shape[0] for e, _ in fam))
    assert sum(r[0] for r in split["rounds"]) == n - 1


def test_chain_tree_matches_jax(monkeypatch):
    """A left-deep chain: every level one merge (JAX runs them as its
    scanned tail chunks, the port as batch-1 steps)."""
    n = jpp._POOL_SCAN_CHUNK + 5
    fam = _family(np.random.default_rng(7), n, 30)
    tree = 0
    for k in range(1, n):
        tree = (tree, k)
    (j, t, h), jlog, tlog, split = _run_all(fam, tree, monkeypatch)
    assert t == j == h and split["path"] == "pool"
    assert _assert_same_levels(jlog, tlog) == n - 1


def test_base_embeddings_match_jax(monkeypatch):
    fam = _family(np.random.default_rng(11), 8, 20, base_dim=6)
    (j, t, h), jlog, tlog, split = _run_all(fam, _nj_tree(11, 8), monkeypatch, sw=0.4)
    assert t == j == h and split["path"] == "pool"
    _assert_same_levels(jlog, tlog)


def test_fast_dp_matches_jax(monkeypatch):
    monkeypatch.setenv("GINFINITY_PROFILE_DP", "fast")
    fam = _family(np.random.default_rng(101), 10, 25)
    (j, t, h), jlog, tlog, split = _run_all(fam, _nj_tree(1, 10), monkeypatch)
    assert t == j == h and split["path"] == "pool"
    _assert_same_levels(jlog, tlog)


def test_overflow_falls_back_like_jax(monkeypatch, capsys):
    """Positive gap scores make every merge all-gap, so merged lengths
    outgrow P: both pools return None and both fall back to the host
    loop; the port says so and records the path."""
    rng = np.random.default_rng(5)
    fam = [(jmsa._l2_normalize_rows(rng.normal(size=(30, 8)).astype(np.float32)), None)
           for _ in range(8)]
    (j, t, h), jlog, tlog, split = _run_all(fam, _nj_tree(5, 8), monkeypatch, go=2.0, ge=2.0)
    assert jlog == [None] and tlog == [None]
    assert t == j == h and split["path"] == "overflow->host"
    assert "pool overflowed" in capsys.readouterr().out


def test_padding_helpers_match_jax():
    from ginfinity_tpu.ops.library_pool import _member_capacity

    for m in list(range(0, 70)) + [120, 255, 256, 300, 315, 384, 500]:
        assert tpp.pool_padded_len(m) == jpp.pool_padded_len(m)
        assert tpp.library_pool_padded_len(m) == jpp.library_pool_padded_len(m)
        assert tpp._member_capacity(m) == _member_capacity(m)
        assert tph._pow2_batch(max(1, m)) == jph._pow2_batch(max(1, m))


def test_seq_row_norm_is_the_sequential_sum():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    s = np.zeros((3, 7), np.float32)
    for k in range(16):
        s = s + x[..., k] * x[..., k]
    np.testing.assert_array_equal(tpp.seq_row_norm(torch.from_numpy(x)).numpy()[..., 0],
                                  np.sqrt(s))
