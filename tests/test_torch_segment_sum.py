"""The card's segment sums, run here on the CPU.

On the card ``models/gine.py::_segment_sum`` is ``_ordered_segment_sum``
(the card's ``index_add_`` adds with atomics, in an order that changes
from run to run).  It must give the CPU's ``index_add_`` sums bit for
bit, so these tests hold it to ``index_add_`` with no tolerance: on bare
sums of every shape the model passes (2-D rows, 1-D and one-column rows,
float64, empty segments, unsorted indices), and through the whole model
(node embeddings and pooled outputs of each norm and pooling) with
``_segment_sum`` swapped for it.  The card runs the same code; the smoke's
node checks hold it there (``chip_smoke.py``, ``align_path``).

Training differentiates through the same sums: ``_SegmentSum`` (backward:
the gather) and ``_Gather`` (backward: the index-ordered sum, never the
card's atomic ``index_add_``).  On the CPU their gradients must be
autograd's through ``index_add_``/``index_select``, bit for bit, so CPU
training is what it would be without them (the smoke's ``train_path``
holds two card runs of a step to each other)."""

import numpy as np
import pytest
import torch

from ginfinity_tpu_torch.graphs.batching import batch_graphs
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.gine import GINConfig, init_params
from ginfinity_tpu_torch.pipelines.engine import preprocess_structures
from ginfinity_tpu_torch.training.train import tree_map

STRUCTURES = ["((((....))))..((...))", "(((..((...))..)))", ".", "..((((.....))))....",
              "((.((...)).))((...))"]


@pytest.mark.parametrize("shape,n,sorted_seg,dtype", [
    ((300, 16), 40, False, torch.float32),
    ((300,), 40, False, torch.float32),
    ((300, 1), 7, True, torch.float32),
    ((2000,), 3, True, torch.float32),
    ((300, 16), 40, False, torch.float64),
    ((0, 4), 3, False, torch.float32),
])
def test_ordered_sum_is_index_add(shape, n, sorted_seg, dtype):
    """Bit-equal to ``index_add_`` into zeros; segments 5 and 6 stay
    empty and read 0."""
    rng = np.random.default_rng(0)
    seg = rng.choice([s for s in range(n) if s not in (5, 6)], size=shape[0]).astype(np.int32)
    seg = torch.from_numpy(np.sort(seg) if sorted_seg else seg)
    x = torch.from_numpy(rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).to(dtype)
    want = torch.zeros((n,) + shape[1:], dtype=dtype).index_add_(0, seg, x)
    got = gine._ordered_segment_sum(x, seg, n)
    assert got.dtype == dtype and torch.equal(got, want)


def test_plan_is_kept_on_the_index_tensor():
    """One sort per index tensor and segment count, reused by later sums."""
    seg = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    order, offsets = gine._segment_plan(seg, 3)
    assert order.tolist() == [1, 4, 3, 0, 2] and offsets.tolist() == [0, 2, 3, 5]
    assert gine._segment_plan(seg, 3)[0] is order
    assert gine._segment_plan(seg, 4)[1].tolist() == [0, 2, 3, 5, 5]


@pytest.mark.parametrize("change", [
    dict(norm_type="graph", pooling_type="global_mean_pool", node_embed_norm="zscore_l2"),
    dict(norm_type="layer", pooling_type="set2set"),
    dict(norm_type="instance", pooling_type="global_add_pool", normalize_nodes_before_pool=True,
         node_embed_norm="l2"),
    dict(norm_type="graph", pooling_type="global_add_pool", graph_encoding="forgi"),
])
def test_model_through_ordered_sums(monkeypatch, change):
    """Node embeddings and pooled outputs are bit-equal whether the
    model's segment sums run through ``index_add_`` or the card's
    ordered sums."""
    cfg = GINConfig.create(hidden_dim=16, output_dim=8, gin_layers=3, **change)
    params, state = init_params(torch.Generator().manual_seed(3), cfg)
    graphs = preprocess_structures(STRUCTURES, graph_encoding=cfg.graph_encoding,
                                   feature_dim=cfg.node_feature_dim).graphs
    batch = batch_graphs(graphs, graph_capacity=8)
    want = (gine.get_node_embeddings(cfg, params, state, batch),
            gine.forward_once(cfg, params, state, batch))
    monkeypatch.setattr(gine, "_segment_sum", gine._ordered_segment_sum)
    got = (gine.get_node_embeddings(cfg, params, state, batch),
           gine.forward_once(cfg, params, state, batch))
    for g, w in zip(got, want):
        assert torch.isfinite(w).all() and torch.equal(g, w)


def _plain_sum(x, seg, n):
    return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype).index_add(0, seg, x)


@pytest.mark.parametrize("shape,n,dtype", [
    ((300, 16), 40, torch.float32), ((300,), 40, torch.float32), ((300, 16), 7, torch.float64),
])
def test_autograd_pair_gradients_are_index_add(shape, n, dtype):
    """The pair's gradients equal autograd's through ``index_add`` and
    ``index_select``, bit for bit, with repeated and unsorted indices."""
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(rng.integers(0, n, size=shape[0]).astype(np.int32))
    x0 = torch.from_numpy(rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape))
    x0 = x0.to(dtype)
    for ours, plain, out_rows in (
        (gine._segment_sum, _plain_sum, n),
        (lambda x, s, _: gine._gather(x, s), lambda x, s, _: x.index_select(0, s), shape[0]),
    ):
        w = torch.from_numpy(rng.normal(size=(out_rows,) + shape[1:])).to(dtype)
        grads = []
        for fn in (ours, plain):
            x = x0.clone().requires_grad_(True)
            (fn(x, seg, n) * w).sum().backward()
            grads.append(x.grad)
        assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("change", [
    dict(norm_type="graph", pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
         normalize_nodes_before_pool=True),
    dict(norm_type="layer", pooling_type="set2set"),
    dict(norm_type="instance", pooling_type="global_add_pool"),
    dict(norm_type="batch", pooling_type="global_add_pool", train_eps=False),
])
def test_train_gradients_through_the_pair(monkeypatch, change):
    """A train-mode forward's parameter gradients are bit-equal whether the
    model's gathers and sums run through the autograd pair or through
    plain ``index_select`` and ``index_add``."""
    cfg = GINConfig.create(hidden_dim=16, output_dim=8, gin_layers=3, dropout=0.0, **change)
    params, state = init_params(torch.Generator().manual_seed(4), cfg)
    graphs = preprocess_structures(STRUCTURES, feature_dim=cfg.node_feature_dim).graphs
    batch = batch_graphs(graphs, graph_capacity=8)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32))

    def grads():
        tree = tree_map(lambda t: t.clone().requires_grad_(True), params)
        out, _ = gine.forward_once_train(cfg, tree, state, batch)
        (out * w).sum().backward()
        return [leaf.grad for _, leaf in gine._leaves((), tree)]

    want = grads()
    monkeypatch.setattr(gine, "_gather", lambda x, i: x.index_select(0, i))
    monkeypatch.setattr(gine, "_segment_sum", _plain_sum)
    got = grads()
    # eps takes no gradient when train_eps is off
    assert sum(g is None for g in want) == (0 if cfg.train_eps else cfg.gin_layers)
    assert all(torch.isfinite(g).all() for g in want if g is not None)
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(want, got))

