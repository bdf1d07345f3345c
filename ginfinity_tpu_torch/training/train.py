"""Train step, eval step, train state and early stopping.

Port of ``ginfinity_tpu/training/train.py`` on one device.  The train
step is forward, loss, ``backward`` and one Adam step with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8, no weight decay), in place on the
state's tensors.  Train mode (dropout, batch norm's batch statistics)
runs when a dropout generator is given, as the JAX step runs it when
given a key; the eval step runs in inference mode.

Loss modes:
  triplet:    TripletMarginLoss(margin=1, p=2) on (a, p, n) embeddings;
              the model state goes a -> p -> n, so batch norm's running
              statistics move three times a step
  regression: MSE(1 - cos(a, p), target)
  alignment:  AlignmentContrastiveLoss on gathered node subsets

With a ``mesh`` (``parallel/mesh.py``) the steps are the JAX package's
``shard_map`` steps: batch ``s`` of a stacked batch runs on the mesh's
device ``s`` against a replica of the parameters, with a dropout
generator of its own (seeded from the step generator's seed, the step
count and ``s``, as ``fold_in(rng, axis_index("data"))``); the losses, gradients and new
model states are averaged over the shards (``pmean``: summed in shard
order on the first device), so batch norm's statistics are each shard's
own and its running statistics are averaged; then one Adam step updates
the parameters on the first device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.batching import GraphBatch
from ginfinity_tpu_torch.models.gine import (
    GINConfig,
    Params,
    State,
    _gather,
    _leaves,
    forward_once,
    forward_once_train,
    get_node_embeddings,
    get_node_embeddings_train,
)
from ginfinity_tpu_torch.training.losses import AlignmentLossConfig, alignment_contrastive_loss
from ginfinity_tpu_torch.utils import trace

ADAM_BETAS = (0.9, 0.999)  # optax.adam's b1, b2
ADAM_EPS = 1e-8


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _batch_to(batch, device):
    """A batch dataclass with every tensor on ``device``."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(device) for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), (torch.Tensor, GraphBatch))
    })


@dataclasses.dataclass
class TripletBatch:
    anchor: GraphBatch
    positive: GraphBatch
    negative: GraphBatch
    mask: torch.Tensor  # [G] 1.0 for real triplets

    to = _batch_to


@dataclasses.dataclass
class PairBatch:
    anchor: GraphBatch
    positive: GraphBatch
    target: torch.Tensor  # [G]
    mask: torch.Tensor  # [G]

    to = _batch_to


@dataclasses.dataclass
class AlignmentBatch:
    graphs: GraphBatch
    node_idx: torch.Tensor  # [M] indices into the padded node array
    labels: torch.Tensor  # [M] int64
    graph_ids: torch.Tensor  # [M] int32
    categories: torch.Tensor  # [M] int32
    valid: torch.Tensor  # [M] float32

    to = _batch_to


def adam_learning_rate(lr: float) -> float:
    """``lr`` as optax's ``inject_hyperparams`` holds it: float32."""
    return float(np.float32(lr))


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), model state, the Adam
    optimizer over the parameters and the step count."""

    params: Params
    model_state: State
    optimizer: torch.optim.Adam
    step: int = 0

    @classmethod
    def create(cls, params: Params, model_state: State, learning_rate: float) -> "TrainState":
        """A state over copies of ``params`` and ``model_state`` (on their
        device) with a fresh Adam at ``learning_rate``."""
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        model_state = tree_map(lambda t: t.detach().clone(), model_state)
        optimizer = torch.optim.Adam(
            [leaf for _, leaf in _leaves((), params)], lr=adam_learning_rate(learning_rate),
            betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0)
        return cls(params, model_state, optimizer)

    def set_learning_rate(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = adam_learning_rate(lr)

    def detached(self) -> tuple[Params, State]:
        """Copies of the parameters and model state, detached."""
        copy = lambda t: t.detach().clone()
        return tree_map(copy, self.params), tree_map(copy, self.model_state)


# -- loss adapters -----------------------------------------------------------


def _graph_forward(cfg, params, mstate, graphs, generator):
    if generator is None:
        return forward_once(cfg, params, mstate, graphs), mstate
    return forward_once_train(cfg, params, mstate, graphs, generator)


def triplet_loss_fn(margin: float = 1.0):
    def fn(cfg: GINConfig, params, mstate, batch: TripletBatch, generator):
        a, s1 = _graph_forward(cfg, params, mstate, batch.anchor, generator)
        p, s2 = _graph_forward(cfg, params, s1, batch.positive, generator)
        n, s3 = _graph_forward(cfg, params, s2, batch.negative, generator)
        d_ap = torch.sqrt(((a - p) ** 2).sum(dim=1) + 1e-6)
        d_an = torch.sqrt(((a - n) ** 2).sum(dim=1) + 1e-6)
        per = torch.clamp(d_ap - d_an + margin, min=0.0)
        loss = (per * batch.mask).sum() / torch.clamp(batch.mask.sum(), min=1.0)
        return loss, s3

    return fn


def regression_loss_fn():
    def fn(cfg: GINConfig, params, mstate, batch: PairBatch, generator):
        a, s1 = _graph_forward(cfg, params, mstate, batch.anchor, generator)
        p, s2 = _graph_forward(cfg, params, s1, batch.positive, generator)
        an = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-8)
        pn = p / torch.clamp(torch.linalg.vector_norm(p, dim=1, keepdim=True), min=1e-8)
        pred = 1.0 - (an * pn).sum(dim=1)
        sq = (pred - batch.target) ** 2
        loss = (sq * batch.mask).sum() / torch.clamp(batch.mask.sum(), min=1.0)
        return loss, s2

    return fn


def alignment_loss_fn(loss_cfg: AlignmentLossConfig = AlignmentLossConfig()):
    def fn(cfg: GINConfig, params, mstate, batch: AlignmentBatch, generator):
        # node embeddings with the post-hoc norm applied, as the reference's
        # alignment batch loss takes them
        dev = batch.node_idx.device
        with trace.span("train.encode", device=dev):
            if generator is None:
                x, s1 = get_node_embeddings(cfg, params, mstate, batch.graphs), mstate
            else:
                x, s1 = get_node_embeddings_train(cfg, params, mstate, batch.graphs, generator)
        with trace.span("train.loss", device=dev):
            sub = _gather(x, batch.node_idx)
            loss = alignment_contrastive_loss(sub, batch.labels, batch.graph_ids,
                                              batch.categories, batch.valid, loss_cfg)
        return loss, s1

    return fn


# -- steps --------------------------------------------------------------------


def shard_generators(generator: torch.Generator, mesh, step: int) -> list[torch.Generator]:
    """One dropout generator per shard, on its device, seeded from the
    step's ``generator`` (its seed), the step count and the shard index,
    as the JAX package folds the shard index into each step's key.
    Nothing is drawn from ``generator``: a draw from a card's generator
    is read back on the host, which would then wait for the card every
    step.  A resume restores the step count, so it replays the seeds."""
    return [torch.Generator(device=d).manual_seed(int(np.random.SeedSequence(
        [generator.initial_seed(), step, s]).generate_state(1, np.uint64)[0]) % 2**63)
        for s, d in enumerate(mesh.devices)]


def _replicated(mesh, params: Params, model_state: State) -> list[tuple]:
    """``(params, model_state)`` per shard: the first device's own leaves
    (gradients flow to them), on each other device a copy whose leaves
    require grad."""
    first = mesh.first

    def make(d):
        if d == first:
            return params, model_state
        return (tree_map(lambda t: t.detach().to(d).requires_grad_(True), params),
                tree_map(lambda t: t.to(d), model_state))

    return mesh.replicate(make)


def _sharded_losses(model_config, loss_fn, mesh, ts, batch, generators):
    """Each shard's ``(loss, new model state, parameter leaves)`` of its
    batch of the stack, enqueued shard after shard."""
    from ginfinity_tpu_torch.training.data import _unstack

    out = []
    for s, (d, (params, mstate)) in enumerate(zip(mesh.devices,
                                                  _replicated(mesh, ts.params, ts.model_state))):
        sub = _unstack(batch, s).to(d)
        loss, new_state = loss_fn(model_config, params, mstate, sub,
                                  None if generators is None else generators[s])
        out.append((loss, new_state, [leaf for _, leaf in _leaves((), params)]))
    return out


def _mean_tree(mesh, trees: list):
    """``pmean`` of equal-shaped trees, leaf by leaf."""
    flats = [dict(_leaves((), t)) for t in trees]
    means = {p: mesh.mean([f[p] for f in flats]) for p in flats[0]}

    def rebuild(path, node):
        if isinstance(node, dict):
            return {k: rebuild(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(path + (str(i),), v) for i, v in enumerate(node)]
        return means[path]

    return rebuild((), trees[0])


def make_train_step(model_config: GINConfig, loss_fn: Callable, mesh=None):
    """``step(ts, batch, generator) -> (ts, loss)``: forward (train
    mode), loss, backward and one Adam step, in place on ``ts``;
    ``batch`` on the state's device, ``loss`` a detached 0-d tensor.
    Traced as ``train.step`` around ``train.backward`` and
    ``train.adam`` (the alignment loss adds ``train.encode`` and
    ``train.loss``), each with device events.

    With ``mesh``: the same signature, but ``batch`` is a stack (leading
    axis ``mesh.size``, on any device) and the state lies on the mesh's
    first device; the loss is the shards' mean."""
    if mesh is not None:
        return _make_sharded_train_step(model_config, loss_fn, mesh)

    def step(ts: TrainState, batch, generator: torch.Generator):
        dev = ts.optimizer.param_groups[0]["params"][0].device
        with trace.span("train.step", device=dev):
            ts.optimizer.zero_grad(set_to_none=True)
            loss, new_state = loss_fn(model_config, ts.params, ts.model_state, batch,
                                      generator)
            with trace.span("train.backward", device=dev):
                loss.backward()
            with trace.span("train.adam", device=dev):
                ts.optimizer.step()
            ts.model_state = tree_map(torch.Tensor.detach, new_state)
            ts.step += 1
            return ts, loss.detach()

    return step


def _make_sharded_train_step(model_config: GINConfig, loss_fn: Callable, mesh):
    def step(ts: TrainState, batch, generator: torch.Generator):
        dev = mesh.first
        with trace.span("train.step", device=dev):
            ts.optimizer.zero_grad(set_to_none=True)
            shards = _sharded_losses(model_config, loss_fn, mesh, ts, batch,
                                     shard_generators(generator, mesh, ts.step))
            with trace.span("train.backward", device=dev):
                grads = [torch.autograd.grad(loss, leaves, allow_unused=True)
                         for loss, _, leaves in shards]
            for k, leaf in enumerate(shards[0][2]):
                per = [g[k] for g in grads]
                if any(g is not None for g in per):
                    leaf.grad = mesh.mean([torch.zeros_like(leaf) if g is None else g
                                           for g in per])
            with trace.span("train.adam", device=dev):
                ts.optimizer.step()
            ts.model_state = tree_map(torch.Tensor.detach,
                                      _mean_tree(mesh, [st for _, st, _ in shards]))
            ts.step += 1
            return ts, mesh.mean([loss.detach() for loss, _, _ in shards])

    return step


def make_eval_step(model_config: GINConfig, loss_fn: Callable, mesh=None):
    """Loss only, in inference mode (no dropout, batch norm's running
    statistics, no gradients): ``eval_step(ts, batch) -> loss``; with
    ``mesh``, of a stacked batch, the shards' mean."""

    @torch.no_grad()
    def eval_step(ts: TrainState, batch):
        if mesh is not None:
            shards = _sharded_losses(model_config, loss_fn, mesh, ts, batch, None)
            return mesh.mean([loss for loss, _, _ in shards])
        return loss_fn(model_config, ts.params, ts.model_state, batch, None)[0]

    return eval_step


class EarlyStopping:
    """Patience/min-delta tracker keeping detached copies of the best
    parameters and model state (Adam updates the live ones in place)."""

    def __init__(self, patience: int = 5, min_delta: float = 0.001):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss: float | None = None
        self.early_stop = False
        self.best_params = None
        self.best_model_state = None

    def __call__(self, val_loss: float, ts: TrainState):
        if self.best_loss is None or val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.best_params, self.best_model_state = ts.detached()
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
