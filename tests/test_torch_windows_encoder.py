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
from ginfinity_tpu_torch.models.gine import GINConfig
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
