"""The window encoder of the port (``ops/windows_encoder.py``) against
the JAX package's TPU kernel run as its own tests run it on the CPU
(``forward_windows_pallas(..., interpret=True)``), on the same inputs.

Tolerance: 1e-5 max abs on the float32 embeddings (the port's plain
version and the interpreted kernel differ only in summation order),
except with add pooling of un-normalised nodes, whose outputs reach
~14 in magnitude: there the same order differences over ~80 rows
measured 2.4e-5 (about 12 float32 steps at that size), so that case
holds 5e-5.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.ops import pallas_windows as jpw
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.models.checkpoint import params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig, bf16_round
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops import windows_encoder as we
from ginfinity_tpu_torch.pipelines.fast_windows import (
    _pack_group,
    _prep_corpus_groups,
    _window_chunk,
)

TOL = 1e-5

# the four configs of the TPU kernel's own tests, at small depth, with
# each pooling and each node_embed_norm covered
CASES = {
    "flagship_mean_zscore_l2": (dict(hidden_dims=(128, 128), output_dim=128,
                                     pooling_type="global_mean_pool",
                                     node_embed_norm="zscore_l2",
                                     normalize_nodes_before_pool=True), 40),
    "flagship_add_l2_L120": (dict(hidden_dims=(128, 128), output_dim=128,
                                  pooling_type="global_add_pool",
                                  node_embed_norm="l2",
                                  normalize_nodes_before_pool=True), 120),
    "widths_256_512_512": (dict(hidden_dims=(256, 512, 512), output_dim=512,
                                pooling_type="global_mean_pool",
                                node_embed_norm="zscore",
                                normalize_nodes_before_pool=True), 24),
    "eps_1e-2_gin_eps": (dict(hidden_dims=(128, 128), output_dim=128,
                              pooling_type="global_mean_pool",
                              node_embed_norm="zscore_l2", eps=1e-2, gin_eps=0.1,
                              normalize_nodes_before_pool=True), 40),
    "forgi_edges_no_node_norm": (dict(hidden_dims=(128, 128), output_dim=128,
                                      graph_encoding="forgi", node_feature_dim=16,
                                      edge_feature_dim=7,
                                      pooling_type="global_add_pool",
                                      node_embed_norm="zscore_l2",
                                      normalize_nodes_before_pool=False), 40),
}
CASE_TOL = {"forgi_edges_no_node_norm": 5e-5}


def _models(kw, seed=3):
    """The same random parameters in both packages, with non-trivial
    node_mu / node_sigma (sigmas near 1e-3 when eps is large, so eps
    changes the zscore)."""
    jc, pc = JConfig(**kw), GINConfig(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    h = jc.hidden_dims[-1]
    scale = 1e-3 if jc.eps >= 1e-3 else 1.0
    state = dict(state)
    state["node_mu"] = jnp.asarray(rng.normal(size=h).astype(np.float32) * 0.1)
    state["node_sigma"] = jnp.asarray(scale * (1.0 + rng.random(h)).astype(np.float32))
    p_np = jax.tree_util.tree_map(np.asarray, params)
    s_np = jax.tree_util.tree_map(np.asarray, state)
    pp, ps = params_from_jax(pc, p_np, s_np)
    return jc, params, state, pc, pp, ps


def _chunk(pc, pp, L, C=8, seed=0):
    """Encoder inputs of C windows of seeded structures, built by the
    port's window builder (so the flags are consistent)."""
    rng = np.random.default_rng(seed)
    structs = [random_structure(rng, int(n)) for n in rng.integers(L + 20, L + 120, 6)]
    structs[0] = "((..[[..))..]].." * (L // 16 + 2)
    per, groups = _prep_corpus_groups(pc, structs, L, True, 0.0)
    n_cap, idxs = max(groups.items(), key=lambda kv: len(kv[1]))
    feats, pts, sidx, starts, _ = _pack_group(pc, per, n_cap, idxs)
    n = sum(per[i][4].size for i in idxs)
    sel = np.linspace(0, n - 1, C).astype(np.int64)
    x0, flags = _window_chunk(
        pc, pp, torch.from_numpy(feats), torch.from_numpy(pts).long(),
        torch.from_numpy(sidx[sel]).long(), torch.from_numpy(starts[sel]).long(), L,
    )
    return x0, flags


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_pallas_interpret(name):
    kw, L = CASES[name]
    jc, jp, js, pc, pp, ps = _models(kw)
    x0, flags = _chunk(pc, pp, L)
    assert flags[2].sum() > 0 and flags[1].sum() > 0  # pulled and in-window pairs
    ref = np.asarray(jpw.forward_windows_pallas(
        jc, jp, js, jnp.asarray(x0.numpy()), *(jnp.asarray(f.numpy()) for f in flags),
        L, interpret=True,
    ))
    got = we.forward_windows_reference(pc, pp, ps, x0, *flags, L).numpy()
    assert got.shape == ref.shape == (8, kw["output_dim"])
    np.testing.assert_allclose(got, ref, atol=CASE_TOL.get(name, TOL), rtol=0)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = we.forward_windows.launches
    wrapped = we.forward_windows(pc, pp, ps, x0, *flags, L).numpy()
    np.testing.assert_array_equal(wrapped, got)
    assert we.forward_windows.launches == before


@pytest.mark.parametrize("change", [
    {}, {"norm_type": "none"}, {"hidden_dims": (64,) * 6},
    {"hidden_dims": (256, 512, 512, 512), "output_dim": 512},
    {"output_dim": 96}, {"pooling_type": "set2set"},
    {"node_embed_norm": "l2"}, {"graph_encoding": "forgi", "edge_feature_dim": 7},
])
def test_kernel_gate_matches_pallas_gate(change):
    base = dict(hidden_dims=(128,) * 6, output_dim=128, norm_type="graph",
                pooling_type="global_mean_pool", node_embed_norm="zscore_l2")
    kw = {**base, **change}
    assert we.windows_kernel_ok(GINConfig(**kw)) == jpw.pallas_windows_ok(JConfig(**kw))
    assert we.layer_dims(GINConfig(**kw)) == jpw.layer_dims(JConfig(**kw))


@pytest.mark.parametrize("name", ["widths_256_512_512", "forgi_edges_no_node_norm"])
def test_pack_params_matches_pallas_packing(name):
    """The kernel's flat buffer holds what the TPU kernel's packs hold."""
    kw, _ = CASES[name]
    jc, jp, js, pc, pp, ps = _models(kw)
    jpacks = [np.asarray(a) for a in jpw.pack_params(jc, jp, js)]
    packed = we.pack_params(pc, pp, ps)
    flat, meta = packed.flat.numpy(), packed.meta.numpy()
    dims = we.layer_dims(pc)
    assert packed.max_width == max(max(d) for d in dims)

    def seg(off, shape):
        return flat[off: off + int(np.prod(shape))].reshape(shape)

    for i, (din, dout) in enumerate(dims):
        m = meta[8 * i: 8 * i + 8]
        w0, w1, bb, eb, gn = jpacks[5 * i: 5 * i + 5]
        assert (m[6], m[7]) == (din, dout)
        np.testing.assert_array_equal(seg(m[0], (din, dout)), w0)
        np.testing.assert_array_equal(seg(m[1], (dout, dout)), w1)
        np.testing.assert_array_equal(seg(m[2], (dout,)), bb[0, 0])
        np.testing.assert_array_equal(seg(m[3], (dout,)), bb[1, 0])
        np.testing.assert_allclose(seg(m[4], (5, din)), eb[:5], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(seg(m[5], (3, dout)), gn[:3])
    tail = meta[8 * len(dims):]
    h_last, out_dim = dims[-1][1], pc.output_dim
    zs, fc = jpacks[-2], jpacks[-1]
    np.testing.assert_array_equal(seg(tail[0], (2, h_last)), zs[:2])
    np.testing.assert_array_equal(seg(tail[1], (h_last, out_dim)), fc[:h_last])
    np.testing.assert_array_equal(seg(tail[2], (out_dim,)), fc[h_last])


def test_wrapper_rejects_other_devices_without_fallback():
    kw, L = CASES["flagship_mean_zscore_l2"]
    pc = GINConfig(**kw)
    x0 = torch.empty((8, 2 * L, 128), device="meta")
    flags = [torch.empty((8, L), device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="unsupported device"):
        we.forward_windows(pc, {}, {}, x0, *flags, L)


def test_library_path_keys_sources_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.name == _build.LIB_NAME and first.parent.parent == tmp_path / "_build"
    src.write_text("// b\n")
    assert _build.library_path() != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert len({first, _build.library_path()}) == 2


def test_kernel_source_targets_hopper_without_torch_headers():
    src = (_build.CSRC / "windows_encoder.cu").read_text()
    assert "ginfinity_tpu/ops/pallas_windows.py::_kernel" in src
    assert "torch/extension.h" not in src and "extern \"C\"" in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_config_replace_keeps_gate():
    # a width that is not a multiple of 128 leaves the kernel's gate; the
    # pipeline then runs the plain encoder (tested end to end in
    # test_torch_fast_windows.py)
    pc = GINConfig(hidden_dims=(128, 128), output_dim=128)
    assert we.windows_kernel_ok(pc)
    assert not we.windows_kernel_ok(dataclasses.replace(pc, hidden_dims=(96, 128)))


# ---- what the kernel's tensor-core products consume (3xTF32) ------------


def untile_weight(flat, din, dout):
    """The transposed ``(hi, lo)`` parts, each ``[dout, din]``, of
    ``we.tile_weight``'s output."""
    t = flat.reshape(dout // we.TILE_N, din // we.TILE_K, 2, we.TILE_N // 8, we.TILE_K // 4, 8, 4)
    t = t.permute(2, 0, 3, 5, 1, 4, 6).reshape(2, dout, din)
    return t[0], t[1]


def _tiled_parts(name="widths_256_512_512"):
    kw, _ = CASES[name]
    _, _, _, pc, pp, ps = _models(kw)
    packed = we.pack_params(pc, pp, ps)
    dims = we.layer_dims(pc)
    base = we._LAYER_META * len(dims) + 3
    out = []
    for i, (din, dout) in enumerate(dims):
        for j, (name_, kdim) in enumerate((("mlp0", din), ("mlp1", dout))):
            off = int(packed.meta[base + 2 * i + j])
            out.append((off, kdim, dout, pp["convs"][i][name_]["kernel"],
                        packed.flat[off: off + 2 * kdim * dout]))
    return packed, out


def test_tiled_weights_offsets_and_layout():
    """Per layer two new offsets after the existing meta entries, each on
    a 128-byte boundary, holding W transposed in the kernel's stage order:
    stage (n tile, k stage), then hi and lo, then 8 x 4 core matrices."""
    packed, parts = _tiled_parts()
    n_layers = len(parts) // 2
    assert packed.meta.numel() == we._LAYER_META * n_layers + 3 + 2 * n_layers
    end = 0
    for off, kdim, dout, w, flat in parts:
        assert off % 32 == 0 and off >= end
        end = off + 2 * kdim * dout
        hi, lo = untile_weight(flat, kdim, dout)
        ref_hi, ref_lo = we.tf32_split(w.t())
        assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)
        # the stage image the kernel's descriptors read: element (n, k) of
        # stage (nt, ks), part p at ((n//8 * TILE_K/4 + k//4) * 8 + n%8) * 4 + k%4
        tn, tk = we.TILE_N, we.TILE_K
        stage = flat.reshape(dout // tn, kdim // tk, 2, tn * tk)
        for nt, ks, n, k in ((0, 0, 0, 0), (0, 1, 9, 5), (dout // tn - 1, kdim // tk - 1, 127, 15),
                             (1 % (dout // tn), 3, 64, 10)):
            pos = ((n // 8 * (tk // 4) + k // 4) * 8 + n % 8) * 4 + k % 4
            assert stage[nt, ks, 0, pos] == ref_hi[nt * tn + n, ks * tk + k]
            assert stage[nt, ks, 1, pos] == ref_lo[nt * tn + n, ks * tk + k]
    assert packed.flat.numel() == end


def test_tf32_parts_are_representable_and_rebuild_weights():
    """hi and lo keep the low 13 mantissa bits zero (what the tensor cores
    read), and hi + lo rebuilds each weight within 2^-22 relative."""
    _, parts = _tiled_parts()
    for _, kdim, dout, w, flat in parts:
        hi, lo = untile_weight(flat, kdim, dout)
        for part in (hi, lo):
            assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
        wt = w.t().double()
        err = ((hi.double() + lo.double()) - wt).abs()
        assert bool((err <= 2.0 ** -22 * wt.abs()).all())
        assert float(lo.abs().max()) > 0  # the split is not trivial


def test_tf32_round_is_round_to_nearest_away():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: to nearest, ties away."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -20,
                      one + 1.5 * ulp, 0.0, -0.0], dtype=torch.float32)
    got = we.tf32_round(x).tolist()
    assert got[:4] == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert got[4] == 0.0 and str(got[5]) == "-0.0"


@pytest.mark.parametrize("which", [0, 1, 3])
def test_3xtf32_product_over_packed_parts_matches_float64(which):
    """A plain emulation of the kernel's product, acc = lo*hi' + hi*lo' +
    hi*hi' over the packed weight parts and the split activations,
    accumulated in float32, against the float64 product.  Tolerance: the
    float32 accumulation's own bound, K * 2^-23 * (|A| @ |W|) per
    element (3xTF32 drops lo*lo', about 2^-22 relative per term)."""
    _, parts = _tiled_parts()
    _, kdim, dout, w, flat = parts[which]
    hi, lo = untile_weight(flat, kdim, dout)
    a = torch.from_numpy(np.random.default_rng(which).normal(size=(64, kdim))
                         .astype(np.float32))
    a_hi, a_lo = we.tf32_split(a)
    got = a_lo @ hi.t() + a_hi @ lo.t() + a_hi @ hi.t()
    ref = a.double() @ w.double()
    bound = kdim * 2.0 ** -23 * (a.double().abs() @ w.double().abs())
    assert bool(((got.double() - ref).abs() <= bound).all())
    # a single TF32 pass does not meet it
    one_pass = (a_hi @ hi.t()).double()
    assert float(((one_pass - ref).abs() / bound).max()) > 1


# ---- the bf16 route (Precision.DEFAULT) ----------------------------------
#
# At matmul_precision "bf16" the plain version computes what the TPU kernel
# computes at Precision.DEFAULT, with four rounding points: both MLP
# products, the fc head and the in-window partner rows, which the TPU
# kernel gathers as a product with a one-hot matrix (G @ x).  It is held
# to an independent numpy emulation of pallas_windows.py::_kernel: run in
# float64 on both sides, with the same bf16 operands, the two agree to
# float64 order (1e-9); run in float32, the port stays within the bars
# the card holds K1's bf16 route to (2e-3 max abs, cosine 0.99999).

BF16_TOL, BF16_COS = 2e-3, 0.99999


def _bf16(a):
    """``a`` rounded to bf16 through float32, as float64 (ml_dtypes)."""
    with np.errstate(invalid="ignore"):
        return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                          .astype(jnp.float32)).astype(np.float64)


def _kernel_default_np(jc, jp, js, x0, jl, bp, pulled, fwdw, fwdp, L, round_partner=True):
    """``pallas_windows.py::_kernel`` at Precision.DEFAULT in float64 numpy,
    window by window: every jnp.dot with its operands rounded to bf16."""
    from ginfinity_tpu.graphs.build import window_edge_const_rows

    f = lambda a: np.asarray(a, np.float64)
    dot = lambda a, b: _bf16(a) @ _bf16(b)
    relu = lambda a: np.maximum(a, 0.0)
    attrs = window_edge_const_rows(jc.edge_feature_dim)
    pos = np.arange(L)[:, None]
    m_next, m_prev = (pos <= L - 2).astype(np.float64), (pos >= 1).astype(np.float64)
    out = []
    for w in range(x0.shape[0]):
        x = f(x0[w])
        b, p = f(bp[w])[:, None], f(pulled[w])[:, None]
        fw, fp = f(fwdw[w])[:, None], f(fwdp[w])[:, None]
        G = (np.arange(L)[None, :] == np.asarray(jl[w])[:, None]) * b
        mask = np.concatenate([np.ones((L, 1)), p])
        cnt = L + p.sum()
        for i in range(jc.gin_layers):
            conv, gn = jp["convs"][i], jp["norms"][i]
            eb = dot(attrs, conv["edge_lin"]["kernel"]) + f(conv["edge_lin"]["bias"])
            h_in, xw, xp = x, x[:L], x[L:]
            z = np.zeros((1, x.shape[1]))
            agg_w = relu(np.concatenate([xw[1:], z]) + eb[0]) * m_next \
                + relu(np.concatenate([z, xw[:-1]]) + eb[1]) * m_prev
            xj = dot(G, xw) if round_partner else G @ xw
            e_w = fw * eb[2] + (1 - fw) * eb[3]
            agg_w = agg_w + relu(xj + e_w) * b + relu(xp + e_w) * p
            agg_p = relu(xw + fp * eb[2] + (1 - fp) * eb[3]) * p
            h = (1.0 + f(conv["eps"])) * x + np.concatenate([agg_w, agg_p])
            h = relu(dot(h, conv["mlp0"]["kernel"]) + f(conv["mlp0"]["bias"]))
            h = relu(dot(h, conv["mlp1"]["kernel"]) + f(conv["mlp1"]["bias"]))
            mean = (h * mask).sum(0) / cnt
            o = h - mean * f(gn["mean_scale"])
            var = (o * o * mask).sum(0) / cnt
            h = f(gn["weight"]) * o / np.sqrt(var + 1e-5) + f(gn["bias"])
            x = h + h_in if (jc.use_residual and h.shape == h_in.shape) else h
        mode = jc.node_embed_norm if jc.normalize_nodes_before_pool else "none"
        if mode.startswith("zscore"):
            x = (x - f(js["node_mu"])) / (f(js["node_sigma"]) + jc.eps)
        if mode.endswith("l2"):
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), jc.eps)
        pooled = (x * mask).sum(0, keepdims=True)
        if jc.pooling_type == "global_mean_pool":
            pooled = pooled / cnt
        out.append((dot(pooled, jp["fc"]["kernel"]) + f(jp["fc"]["bias"]))[0])
    return np.stack(out)


def _bf16_setup(name, C=8):
    kw, L = CASES[name]
    jc, jp, js, pc, pp, ps = _models(kw)
    pc = pc.with_precision("bf16")
    x0, flags = _chunk(pc, pp, L, C=C)
    jnp_tree = jax.tree_util.tree_map(np.asarray, (jp, js))
    return jc, jnp_tree, pc, pp, ps, x0, flags, L


def _float64(tree):
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float64(v) for v in tree]
    return tree.double()


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_reference_matches_numpy_kernel_emulation(name):
    jc, (jp, js), pc, pp, ps, x0, flags, L = _bf16_setup(name)
    ref = _kernel_default_np(jc, jp, js, x0.numpy(), *(t.numpy() for t in flags), L)
    got64 = we.forward_windows_reference(pc, _float64(pp), _float64(ps), x0.double(),
                                         *flags, L).numpy()
    np.testing.assert_allclose(got64, ref, atol=1e-9, rtol=0)
    got = we.forward_windows_reference(pc, pp, ps, x0, *flags, L).numpy().astype(np.float64)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert np.abs(got - ref).max() <= BF16_TOL and cos.min() >= BF16_COS
    # precision= overrides the config's; the f32 result is another one
    f32 = we.forward_windows_reference(pc, pp, ps, x0, *flags, L, precision="highest")
    assert torch.equal(we.forward_windows_reference(
        pc.with_precision("highest"), pp, ps, x0, *flags, L), f32)
    assert np.abs(f32.numpy() - got).max() > 1e-5
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = (we.forward_windows.launches, we.forward_windows.bf16_launches)
    wrapped = we.forward_windows(pc, pp, ps, x0, *flags, L).numpy()
    np.testing.assert_array_equal(wrapped, got.astype(np.float32))
    assert (we.forward_windows.launches, we.forward_windows.bf16_launches) == before


def test_bf16_partner_rows_are_rounded():
    """A window whose in-window partners (bp_in set) hold values that bf16
    cannot represent: the plain version reads bf16(x[j]), as the TPU
    kernel's one-hot product does, and not x[j] (the XLA path's exact
    gather, ``exact_gather=True``)."""
    jc, (jp, js), pc, pp, ps, x0, flags, L = _bf16_setup("flagship_mean_zscore_l2")
    jl, bp = flags[0].long(), flags[1] > 0
    assert bp.sum() > 0
    partners = torch.gather(x0[:, :L], 1, jl[..., None].expand(-1, -1, x0.shape[2]))[bp]
    assert bool((bf16_round(partners) != partners).all(dim=1).any())
    args = (x0.numpy(), *(t.numpy() for t in flags), L)
    rounded = _kernel_default_np(jc, jp, js, *args)
    exact = _kernel_default_np(jc, jp, js, *args, round_partner=False)
    p64, s64, x64 = _float64(pp), _float64(ps), x0.double()
    got = we.forward_windows_reference(pc, p64, s64, x64, *flags, L).numpy()
    got_exact = we.forward_windows_reference(pc, p64, s64, x64, *flags, L,
                                             exact_gather=True).numpy()
    np.testing.assert_allclose(got, rounded, atol=1e-9, rtol=0)
    np.testing.assert_allclose(got_exact, exact, atol=1e-9, rtol=0)
    assert np.abs(rounded - exact).max() > 1e-6


@pytest.mark.parametrize("name", ["flagship_mean_zscore_l2", "forgi_edges_no_node_norm"])
def test_bf16_reference_near_pallas_interpret_at_default(name):
    """The TPU kernel interpreted on the CPU at its bf16 setting computes
    float32 products (the CPU ignores Precision.DEFAULT), so the port's
    bf16 is held to it by cosine only."""
    kw, L = CASES[name]
    jc, jp, js, pc, pp, ps = _models(kw)
    jc, pc = jc.with_precision("bf16"), pc.with_precision("bf16")
    x0, flags = _chunk(pc, pp, L)
    ref = np.asarray(jpw.forward_windows_pallas(
        jc, jp, js, jnp.asarray(x0.numpy()), *(jnp.asarray(f.numpy()) for f in flags),
        L, interpret=True,
    ), np.float64)
    got = we.forward_windows_reference(pc, pp, ps, x0, *flags, L).numpy().astype(np.float64)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.999


def untile_weight_bf16(flat, din, dout):
    """``W`` transposed (``[dout, din]``, bf16) from ``we.tile_weight_bf16``'s
    output."""
    tn, tk = we.TILE_N, we.TILE_K_BF16
    t = flat.reshape(dout // tn, din // tk, tn // 8, tk // 8, 8, 8)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(dout, din)


def test_tiled_bf16_weights_offsets_and_layout():
    """At bf16 the packed buffer holds each W transposed, rounded once to
    bf16, two values to a float32 slot, each on a 128-byte boundary, in
    the stage order of the bf16 route: stage (n tile, k stage) of 128 x 64
    values, then 8 x 8 core matrices; the edge rows are at bf16 too."""
    kw, _ = CASES["widths_256_512_512"]
    _, _, _, pc, pp, ps = _models(kw)
    pc = pc.with_precision("bf16")
    packed = we.pack_params(pc, pp, ps)
    assert packed.precision == "bf16"
    dims = we.layer_dims(pc)
    base = we._LAYER_META * len(dims) + 3
    assert packed.meta.numel() == base + 2 * len(dims)
    end = 0
    for i, (din, dout) in enumerate(dims):
        conv = pp["convs"][i]
        eb = packed.flat[int(packed.meta[8 * i + 4]):][: 4 * din].reshape(4, din)
        assert torch.equal(eb, we._edge_rows(pc, conv))
        for j, (name, kdim) in enumerate((("mlp0", din), ("mlp1", dout))):
            off = int(packed.meta[base + 2 * i + j])
            assert off % 32 == 0 and off >= end
            end = off + kdim * dout // 2
            flat = packed.flat[off:end].contiguous().view(torch.bfloat16)
            ref = conv[name]["kernel"].t().to(torch.bfloat16)
            assert torch.equal(untile_weight_bf16(flat, kdim, dout), ref)
            assert torch.equal(we.tile_weight_bf16(conv[name]["kernel"]), flat)
            # element (n, k) of stage (nt, ks) at ((n//8 * 8 + k//8) * 8 + n%8) * 8 + k%8
            tn, tk = we.TILE_N, we.TILE_K_BF16
            stage = flat.reshape(dout // tn, kdim // tk, tn * tk)
            assert tn * tk * 2 == 2 * tn * we.TILE_K * 4  # one ring slot, 16 KB
            for nt, ks, n, k in ((0, 0, 0, 0), (0, 1, 9, 13), (dout // tn - 1, kdim // tk - 1,
                                                                127, 63), (1, 2, 64, 40)):
                at = ((n // 8 * (tk // 8) + k // 8) * 8 + n % 8) * 8 + k % 8
                assert stage[nt, ks, at] == ref[nt * tn + n, ks * tk + k]
    assert packed.flat.numel() == end
