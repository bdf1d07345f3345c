"""The port's training pieces against the JAX package on the CPU: the
losses, one train step's loss and gradients in each mode, Adam with a
changing learning rate, the host batches of ``training/data.py``,
``fit_node_stats`` and dropout.

Tolerances.  Losses 1e-6.  A train step's loss within 1e-5 relative and
each gradient leaf within ``1e-5 * max(1, max|g|)`` of JAX's, at dropout
0 (the two frameworks' random streams differ).  GraphNorm amplifies the
last-bit differences of the two float32 sides layer by layer, and the
alignment loss's logits (cos / 0.1) amplify them again; where a leaf is
farther apart than that, the port's float32 gradient must lie within
``1e-5 * max(1, max|g|)`` plus twice the JAX gradient's distance of a
float64 run of the port.  (Over seeds, both float32 sides sit 1e-7 to
1e-3 of the largest gradient from float64, the port nearer about half
the time.)
Batch norm's new running statistics 1e-6.  Adam: parameters within 1e-6
after 10 steps.  Batches: every array equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from ginfinity_tpu.graphs import batching as jbatching
from ginfinity_tpu.graphs import build as jbuild
from ginfinity_tpu.models import gine as jgine
from ginfinity_tpu.training import data as JD
from ginfinity_tpu.training import losses as JL
from ginfinity_tpu.training import train as JT
from ginfinity_tpu_torch.graphs import batching, build
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.gine import GINConfig, _leaves
from ginfinity_tpu_torch.training import data as D
from ginfinity_tpu_torch.training import losses as L
from ginfinity_tpu_torch.training import train as T
from ginfinity_tpu_torch.utils.io import read_table

from torch_train_data import jax_init, structures, write_alignment, write_pairs

LOSS_TOL = 1e-6
STEP_TOL = 1e-5


# -- losses ---------------------------------------------------------------


def _loss_inputs(seed, n=40, d=16, pad=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n + pad, d)).astype(np.float32)
    labels = np.concatenate([rng.integers(0, 10, size=n), -2_000_000_000 - np.arange(pad)])
    graph_ids = np.concatenate([rng.integers(0, 4, size=n), np.full(pad, -1)]).astype(np.int32)
    cats = np.concatenate([rng.integers(0, 6, size=n), np.full(pad, 5)]).astype(np.int32)
    valid = np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)
    return emb, labels.astype(np.int64), graph_ids, cats, valid


@pytest.mark.parametrize("margin,temperature,pad", [
    (0.0, 0.1, 0), (0.2, 0.1, 0), (0.2, 0.07, 12), (0.0, 0.5, 12), (1.5, 0.1, 5),
])
def test_alignment_loss_matches_jax(margin, temperature, pad):
    emb, labels, gids, cats, valid = _loss_inputs(int(margin * 10) + pad, pad=pad)
    cfg_j = JL.AlignmentLossConfig(margin=margin, temperature=temperature)
    cfg_p = L.AlignmentLossConfig(margin=margin, temperature=temperature)
    want = float(jax.jit(JL.alignment_contrastive_loss, static_argnums=5)(
        emb, labels, gids, cats, valid, cfg_j))
    t = torch.from_numpy
    got = float(L.alignment_contrastive_loss(t(emb), t(labels), t(gids), t(cats), t(valid), cfg_p))
    assert want > 0 and abs(got - want) <= LOSS_TOL * max(1.0, abs(want))
    if pad:
        base = float(L.alignment_contrastive_loss(t(emb[:-pad]), t(labels[:-pad]),
                                                  t(gids[:-pad]), t(cats[:-pad]),
                                                  t(valid[:-pad]), cfg_p))
        assert abs(base - got) <= LOSS_TOL * max(1.0, abs(base))


def test_alignment_loss_without_positives_is_zero():
    emb, labels, gids, cats, valid = _loss_inputs(1, n=6)
    labels = np.arange(6, dtype=np.int64)
    t = torch.from_numpy
    assert float(L.alignment_contrastive_loss(t(emb), t(labels), t(gids), t(cats),
                                              t(valid))) == 0.0


@pytest.mark.parametrize("margin", [1.0, 0.3])
def test_triplet_and_regression_losses_match_jax(margin):
    rng = np.random.default_rng(4)
    a, p, n = (rng.normal(size=(9, 8)).astype(np.float32) for _ in range(3))
    t = torch.from_numpy
    want = float(JL.triplet_loss(a, p, n, margin))
    assert abs(float(L.triplet_loss(t(a), t(p), t(n), margin)) - want) <= LOSS_TOL
    want = float(JL.regression_loss(a, p))
    assert abs(float(L.regression_loss(t(a), t(p))) - want) <= LOSS_TOL


# -- datasets and batches -------------------------------------------------


def _tree_equal(jb, pb, path=""):
    """Every array of a JAX batch equals the port batch's (int64 labels
    come out of JAX as int32: values compared)."""
    if dataclasses.is_dataclass(pb):
        for f in dataclasses.fields(pb):
            _tree_equal(getattr(jb, f.name), getattr(pb, f.name), f"{path}.{f.name}")
        return
    if isinstance(pb, int):
        assert jb == pb, path
        return
    a, b = np.asarray(jb), pb.numpy()
    assert a.shape == b.shape and np.array_equal(a, b), path
    if not path.endswith("labels"):
        assert a.dtype == b.dtype, path


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_data")
    return {
        "triplet": write_pairs(d / "triplets.tsv", "triplet"),
        "regression": write_pairs(d / "pairs.tsv", "regression"),
        "alignment": write_alignment(d / "align"),
    }


def _datasets(mode, files):
    """(JAX dataset, port dataset) of one mode's file."""
    if mode == "alignment":
        import json

        data_p, map_p = files["alignment"]
        with open(map_p) as f:
            amap = json.load(f)
        return (JD.AlignmentDataset(pd.read_csv(data_p, sep="\t"), amap),
                D.AlignmentDataset(read_table(data_p, sep="\t"), amap))
    path = files[mode]
    cols = [c for c in ("anchor_structure", "positive_structure", "negative_structure")
            if mode == "triplet" or c != "negative_structure"]
    df = JD.remove_invalid_structures(pd.read_csv(path, sep="\t", comment="#"), cols)
    table = D.remove_invalid_structures(read_table(path, sep="\t", comment="#"), cols)
    kind = "TripletDataset" if mode == "triplet" else "PairDataset"
    return getattr(JD, kind)(df), getattr(D, kind)(table)


@pytest.mark.parametrize("mode", ["triplet", "regression", "alignment"])
def test_batches_equal_jax(mode, data_files):
    """Shuffled epochs, alignment negatives drawn and subsampled, and the
    data-parallel stacks: the same batches as the JAX package from the
    same generator."""
    jds, pds = _datasets(mode, data_files)
    assert len(jds) == len(pds) > 4
    runs = []
    for pkg, ds in (("jax", jds), ("port", pds)):
        m = JD if pkg == "jax" else D
        rng = np.random.default_rng(11)
        if mode == "alignment":
            plain = list(m.iter_alignment_batches(ds, 2, 3, rng, max_negatives=5,
                                                  hard_negative_fraction=0.5))
            dp = list(m.iter_alignment_batches_dp(ds, 1, 3, 2, rng, max_negatives=20))
        else:
            it = m.iter_triplet_batches if mode == "triplet" else m.iter_pair_batches
            build_fn = m._triplet_batch if mode == "triplet" else m._pair_batch
            plain = list(it(ds, 5, rng)) + list(it(ds, 7, None))
            dp = list(m.iter_graph_pair_batches_dp(ds, 4, 2, rng, build_fn))
        runs.append((plain, dp, rng.random()))
    (jp, jdp, jnext), (pp, pdp, pnext) = runs
    assert len(jp) == len(pp) and len(jdp) == len(pdp) and jnext == pnext
    for jb, pb in zip(jp, pp):
        _tree_equal(jb, pb)
    for (jb, js), (pb, ps) in zip(jdp, pdp):
        assert js == ps
        _tree_equal(jb, pb)
    assert any(s for _, s in pdp)


def test_subsample_negatives_matches_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 30, size=200).astype(np.int64)
    graphs = rng.integers(0, 8, size=200).astype(np.int32)
    cats = rng.integers(0, 6, size=200).astype(np.int32)
    for max_neg, frac in ((None, 0.85), (0, 0.85), (10, 0.85), (40, 0.5), (500, 1.0)):
        want = JD.subsample_negatives(labels, graphs, cats, max_neg, frac,
                                      np.random.default_rng(1))
        got = D.subsample_negatives(labels, graphs, cats, max_neg, frac,
                                    np.random.default_rng(1))
        assert np.array_equal(want, got)


# -- one train step ---------------------------------------------------------


def _step_batches(mode, norm, files):
    """The same first batch of one mode in both packages."""
    jds, pds = _datasets(mode, files)
    if mode == "alignment":
        jb = JD.assemble_alignment_batch(jds.groups[:3], 4, np.random.default_rng(0),
                                         max_negatives=30)
        pb = D.assemble_alignment_batch(pds.groups[:3], 4, np.random.default_rng(0),
                                        max_negatives=30)
    else:
        fn = "_triplet_batch" if mode == "triplet" else "_pair_batch"
        jb = getattr(JD, fn)(jds, np.arange(6), 8, None)
        pb = getattr(D, fn)(pds, np.arange(6), 8, None)
    return jb, pb


_LOSS_FNS = {"triplet": "triplet_loss_fn", "regression": "regression_loss_fn",
             "alignment": "alignment_loss_fn"}


def _cast(tree, dtype):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _cast(getattr(tree, f.name), dtype) for f in dataclasses.fields(tree)
            if not isinstance(getattr(tree, f.name), int)})
    return tree.to(dtype) if tree.is_floating_point() else tree


def _port_step(cfg, mode, params, state, batch, dtype=torch.float32):
    params = T.tree_map(lambda t: t.to(dtype).clone().requires_grad_(True), params)
    state = T.tree_map(lambda t: t.to(dtype), state)
    loss, new_state = getattr(T, _LOSS_FNS[mode])()(cfg, params, state, _cast(batch, dtype),
                                                    torch.Generator().manual_seed(0))
    loss.backward()
    grads = {"/".join(k): (v.grad if v.grad is not None else torch.zeros_like(v)).double()
             for k, v in _leaves((), params)}
    return float(loss.detach()), grads, new_state


CASES = [
    ("triplet", "graph", True, {}), ("triplet", "batch", False, {}),
    ("triplet", "instance", True, {"pooling_type": "global_mean_pool"}),
    ("regression", "graph", False, {"normalize_nodes_before_pool": True}),
    ("regression", "layer", True, {}), ("regression", "batch", True, {}),
    ("alignment", "graph", True, {}), ("alignment", "instance", False, {}),
    ("alignment", "none", True, {}), ("alignment", "batch", False, {}),
]


@pytest.mark.parametrize("mode,norm,train_eps,extra", CASES)
def test_train_step_matches_jax(mode, norm, train_eps, extra, data_files):
    kw = dict(hidden_dim=32, output_dim=16, gin_layers=2, norm_type=norm, train_eps=train_eps,
              use_residual=True, dropout=0.0, gin_eps=0.1,
              node_embed_norm="zscore_l2" if mode == "alignment" else "none", **extra)
    jc, jp, js, (pp, ps) = jax_init(kw, seed=len(mode) + len(norm))
    cfg = GINConfig.create(**kw)
    jb, pb = _step_batches(mode, norm, data_files)

    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        lambda p: getattr(JT, _LOSS_FNS[mode])()(jc, p, js, jb, jax.random.PRNGKey(0)),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, jp))
    jg = {"/".join(k): np.asarray(v, np.float64) for k, v in _leaves((), jgrads)}
    loss, grads, new_state = _port_step(cfg, mode, pp, ps, pb)

    assert abs(loss - float(jloss)) <= STEP_TOL * max(1.0, abs(float(jloss)))
    assert grads.keys() == jg.keys()
    ref64 = None
    for k, g in grads.items():
        g, want = g.numpy(), jg[k]
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(g - want).max())
        if err <= STEP_TOL * scale:
            continue
        if ref64 is None:
            ref64 = _port_step(cfg, mode, pp, ps, pb, torch.float64)[1]
        r = ref64[k].numpy()
        assert np.abs(g - r).max() <= 2 * np.abs(want - r).max() + STEP_TOL * scale, (k, err)
    if not train_eps:
        assert all(float(np.abs(jg[f"convs/{i}/eps"]).max()) == 0.0 for i in range(2))
        assert all(float(grads[f"convs/{i}/eps"].abs().max()) == 0.0 for i in range(2))
    if norm == "batch":
        for i, bn in enumerate(new_state["batch_norms"]):
            for key in ("running_mean", "running_var"):
                want = np.asarray(jstate["batch_norms"][i][key])
                assert not np.array_equal(want, np.asarray(js["batch_norms"][i][key]))
                np.testing.assert_allclose(bn[key].numpy(), want, atol=1e-6, rtol=0)
                assert not bn[key].requires_grad


def test_triplet_threads_batch_norm_state_three_times(data_files):
    """A triplet step moves the running statistics three times, a -> p ->
    n, as the JAX step does; the eval step leaves them alone."""
    kw = dict(hidden_dim=16, output_dim=8, gin_layers=1, norm_type="batch", dropout=0.0)
    _, _, _, (pp, ps) = jax_init(kw)
    cfg = GINConfig.create(**kw)
    _, pb = _step_batches("triplet", "batch", data_files)
    want = ps
    for g in (pb.anchor, pb.positive, pb.negative):
        want = gine.forward_once_train(cfg, pp, want, g)[1]
    ts = T.TrainState.create(pp, ps, 1e-3)
    T.make_eval_step(cfg, T.triplet_loss_fn())(ts, pb)
    assert torch.equal(ts.model_state["batch_norms"][0]["running_mean"],
                       ps["batch_norms"][0]["running_mean"])
    ts, loss = T.make_train_step(cfg, T.triplet_loss_fn())(ts, pb, torch.Generator())
    assert ts.step == 1 and torch.isfinite(loss)
    for key in ("running_mean", "running_var"):
        got = ts.model_state["batch_norms"][0][key]
        assert torch.equal(got, want["batch_norms"][0][key])
        assert not torch.equal(got, gine.forward_once_train(cfg, pp, ps, pb.anchor)[1][
            "batch_norms"][0][key])


# -- Adam ---------------------------------------------------------------------


def test_adam_with_decay_matches_optax():
    """The same gradients through optax's ``inject_hyperparams(adam)`` and
    the port's Adam, the learning rate changed every step."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=4).astype(np.float32)]}
    grads = [{"a": (rng.normal(size=(5, 3)) * 10.0 ** rng.integers(-6, 1)).astype(np.float32),
              "b": [rng.normal(size=4).astype(np.float32)]} for _ in range(10)]
    grads[3]["b"][0][:] = 0.0
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jparams)
    ts = T.TrainState.create(T.tree_map(torch.from_numpy, params), {}, 1e-3)
    lr = 1e-3
    for g in grads:
        upd, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for (_, leaf), (_, gv) in zip(_leaves((), ts.params), _leaves((), g)):
            leaf.grad = torch.from_numpy(gv.copy())
        ts.optimizer.step()
        lr *= 0.7
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        ts.set_learning_rate(lr)
    for (_, got), (_, want) in zip(_leaves((), ts.params), _leaves((), jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert ts.optimizer.param_groups[0]["lr"] == float(np.float32(lr))


# -- fit_node_stats, dropout --------------------------------------------------


def test_fit_node_stats_matches_jax():
    kw = dict(hidden_dim=32, output_dim=16, gin_layers=2, node_embed_norm="zscore_l2")
    jc, jp, js, (pp, ps) = jax_init(kw, seed=5)
    rng = np.random.default_rng(8)
    chunks = [structures(rng, 7), structures(rng, 4)]
    jb = [jbatching.batch_graphs([jbuild.build_graph_arrays(s) for s in c], 512, 1024, 8)
          for c in chunks]
    pbs = [batching.batch_graphs([build.build_graph_arrays(s) for s in c], 512, 1024, 8)
           for c in chunks]
    want = jgine.fit_node_stats(jc, jax.tree_util.tree_map(jnp.asarray, jp), js, jb)
    cfg = GINConfig.create(**kw)
    got = gine.fit_node_stats(cfg, pp, ps, pbs)
    ref64 = gine.fit_node_stats(cfg, T.tree_map(torch.Tensor.double, pp),
                                T.tree_map(torch.Tensor.double, ps),
                                [_cast(b, torch.float64) for b in pbs])
    for key in ("node_mu", "node_sigma"):
        g, w, r = got[key].numpy(), np.asarray(want[key]), ref64[key].numpy()
        if np.abs(g - w).max() > 1e-6:  # GraphNorm's float32 order: the float64 tie-break
            assert np.abs(g - r).max() <= 2 * np.abs(w - r).max(), key
    assert float(got["node_sigma"].min()) > 0 and float(got["node_mu"].abs().max()) > 0


def test_dropout_masks():
    """The JAX and torch random streams differ, so dropout is held to its
    definition: the kept share, the ``1 / keep`` scale, identity in eval,
    and the same mask from the same seed."""
    x = torch.rand(400, 64) + 0.5
    y = gine._dropout(x, 0.25, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], x[kept] / 0.75)
    assert torch.equal(y, gine._dropout(x, 0.25, torch.Generator().manual_seed(3)))
    assert not torch.equal(y, gine._dropout(x, 0.25, torch.Generator().manual_seed(4)))

    kw = dict(hidden_dim=16, output_dim=8, gin_layers=2, dropout=0.3)
    cfg = GINConfig.create(**kw)
    _, _, _, (pp, ps) = jax_init(kw)
    batch = batching.batch_graphs([build.build_graph_arrays(s) for s in
                                   structures(np.random.default_rng(1), 3)])
    infer = gine.forward_once(cfg, pp, ps, batch)
    assert torch.equal(gine.forward_once_train(cfg, pp, ps, batch)[0], infer)
    a = gine.forward_once_train(cfg, pp, ps, batch, torch.Generator().manual_seed(9))[0]
    b = gine.forward_once_train(cfg, pp, ps, batch, torch.Generator().manual_seed(9))[0]
    assert torch.equal(a, b) and not torch.equal(a, infer)
