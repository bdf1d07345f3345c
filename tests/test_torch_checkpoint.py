"""Checkpoints between the two packages: a ``.pth`` the JAX package
exports imports into the port as the same tensors ``params_from_jax``
carries over (exactly), and the other way round; the loader's metadata
fallbacks agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.models import checkpoint as jckpt
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu_torch.models import checkpoint as ckpt
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, init_params

CONFIGS = {
    "flagship_dropout": dict(hidden_dim=128, output_dim=128, gin_layers=3,
                             pooling_type="global_mean_pool",
                             node_embed_norm="zscore_l2", norm_type="graph",
                             normalize_nodes_before_pool=True),
    "no_dropout_nn2": dict(hidden_dim=[64, 96], output_dim=32, gin_layers=2,
                           dropout=0.0, norm_type="graph"),
    "norm_none_forgi": dict(hidden_dim=32, output_dim=16, gin_layers=2,
                            graph_encoding="forgi", norm_type="none"),
    "layer_norm": dict(hidden_dim=32, output_dim=16, gin_layers=2, norm_type="layer"),
}


def _jax_model(kw, seed=0):
    jc = JConfig.create(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    h = jc.hidden_dims[-1]
    state = dict(state)
    state["node_mu"] = jnp.asarray(rng.normal(size=h).astype(np.float32))
    state["node_sigma"] = jnp.asarray((1.0 + rng.random(h)).astype(np.float32))
    return jc, params, state


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_export_imports_as_params_from_jax(name, tmp_path):
    jc, params, state = _jax_model(CONFIGS[name])
    path = str(tmp_path / "m.pth")
    jckpt.export_torch_checkpoint(path, jc, params, state, epoch=7)
    cfg, p, s, extra = ckpt.import_torch_checkpoint(path)
    assert cfg.to_metadata() == jc.to_metadata()
    assert extra == {"epoch": 7}
    cp, cs = ckpt.params_from_jax(cfg, _np(params), _np(state))
    _assert_trees_equal(p, cp)
    _assert_trees_equal(s, cs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_export_imports_into_jax(name, tmp_path):
    jc, params, state = _jax_model(CONFIGS[name], seed=1)
    cfg = GINConfig.create(**CONFIGS[name])
    p, s = ckpt.params_from_jax(cfg, _np(params), _np(state))
    path = str(tmp_path / "m.pth")
    ckpt.export_torch_checkpoint(path, cfg, p, s)
    jcfg, jp, js, _ = jckpt.import_torch_checkpoint(path)
    assert jcfg == jc
    _assert_trees_equal(_np(jp), p)
    _assert_trees_equal(_np(js), s)
    # and back into the port unchanged
    cfg2, p2, s2, _ = ckpt.import_torch_checkpoint(path)
    assert cfg2 == cfg
    _assert_trees_equal(p2, p)
    _assert_trees_equal(s2, s)


@pytest.mark.parametrize("name", ["flagship_dropout", "norm_none_forgi"])
def test_native_checkpoint_loads(name, tmp_path):
    jc, params, state = _jax_model(CONFIGS[name], seed=2)
    path = str(tmp_path / "m.gin.zip")
    jckpt.save_checkpoint(path, jc, params, state, extra_metadata={"step": 3})
    cfg, p, s, extra = ckpt.load_checkpoint(path)
    assert cfg.to_metadata() == jc.to_metadata() and extra == {"step": 3}
    cp, cs = ckpt.params_from_jax(cfg, _np(params), _np(state))
    _assert_trees_equal(p, cp)
    _assert_trees_equal(s, cs)


ROUND_TRIP = {**CONFIGS, "batch_norm_set2set": dict(hidden_dim=16, output_dim=8, gin_layers=2,
                                                   norm_type="batch", pooling_type="set2set")}


@pytest.mark.parametrize("name", list(ROUND_TRIP))
def test_native_checkpoint_round_trip_both_ways(name, tmp_path):
    """``save_checkpoint``: the port's archive loads into the JAX package as
    JAX's own archive does, and JAX's archive into the port as the
    tensors ``params_from_jax`` carries; config and ``extra`` both ways."""
    jc, params, state = _jax_model(ROUND_TRIP[name], seed=3)
    cfg = GINConfig.create(**ROUND_TRIP[name])
    p, s = ckpt.params_from_jax(cfg, _np(params), _np(state))
    extra = {"step": 5, "note": "round trip", "losses": [0.5, 0.25]}
    jpath, ppath = str(tmp_path / "jax.gin.zip"), str(tmp_path / "sub" / "port.gin.zip")
    jckpt.save_checkpoint(jpath, jc, params, state, extra_metadata=extra)
    ckpt.save_checkpoint(ppath, cfg, p, s, extra_metadata=extra)
    want = jckpt.load_checkpoint(jpath)
    got = jckpt.load_checkpoint(ppath)
    assert got[0] == want[0] == jc and got[3] == want[3] == extra
    _assert_trees_equal(_np(got[1]), _np(want[1]))
    _assert_trees_equal(_np(got[2]), _np(want[2]))
    for path in (jpath, ppath):
        cfg2, p2, s2, extra2 = ckpt.load_checkpoint(path)
        assert cfg2 == cfg and extra2 == extra
        _assert_trees_equal(p2, p)
        _assert_trees_equal(s2, s)
    ckpt.save_checkpoint(ppath, cfg, p, s)
    assert ckpt.load_checkpoint(ppath)[3] == jckpt.load_checkpoint(ppath)[3] == {}


@pytest.mark.parametrize("md", [
    {"hidden_dim": 64, "output_dim": 32},
    {"hidden_dim": 64, "output_dim": 32, "node_feature_dim": 3},
    {"hidden_dims": [64, 128], "output_dim": 32, "gin_layers": 2, "norm_type": "graph",
     "use_residual": True, "seq_weight": None, "graph_encoding": "forgi"},
    {"hidden_dim": [64], "output_dim": 8, "gin_layers": 3, "eps": 1e-3, "gin_eps": 0.2,
     "train_eps": False, "dropout": 0.0, "pooling_type": "global_mean_pool"},
])
def test_config_from_metadata_matches_jax(md):
    got, ref = GINConfig.from_metadata(dict(md)), JConfig.from_metadata(dict(md))
    assert got.to_metadata() == ref.to_metadata()


def test_model_and_init_params_layout():
    kw = CONFIGS["flagship_dropout"]
    cfg, jc = GINConfig.create(**kw), JConfig.create(**kw)
    p, s = init_params(torch.Generator().manual_seed(0), cfg)
    jp, js = jinit(jax.random.PRNGKey(0), jc)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jp))
    mine = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert mine == shapes
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), s) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(js))
    # torch's default Linear bounds, as the JAX init
    bound = np.sqrt(1.0 / 128)
    assert float(p["convs"][1]["mlp0"]["bias"].abs().max()) <= bound
    m = GINModel(cfg, p, s)
    _assert_trees_equal(m.params, p)
    _assert_trees_equal(m.state, s)
