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

Several cards (the JAX step's ``mesh=``) are ROADMAP queue 1, item 11.
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
        if generator is None:
            x, s1 = get_node_embeddings(cfg, params, mstate, batch.graphs), mstate
        else:
            x, s1 = get_node_embeddings_train(cfg, params, mstate, batch.graphs, generator)
        sub = _gather(x, batch.node_idx)
        loss = alignment_contrastive_loss(sub, batch.labels, batch.graph_ids,
                                          batch.categories, batch.valid, loss_cfg)
        return loss, s1

    return fn


# -- steps --------------------------------------------------------------------


def make_train_step(model_config: GINConfig, loss_fn: Callable):
    """``step(ts, batch, generator, marks=None) -> (ts, loss)``: forward
    (train mode), loss, backward and one Adam step, in place on ``ts``;
    ``batch`` on the state's device, ``loss`` a detached 0-d tensor.
    ``marks``, when given, is called with ``"forward"``, ``"backward"``
    and ``"adam"`` as each stage is enqueued (the smoke's CUDA events)."""

    def step(ts: TrainState, batch, generator: torch.Generator, marks=None):
        ts.optimizer.zero_grad(set_to_none=True)
        loss, new_state = loss_fn(model_config, ts.params, ts.model_state, batch, generator)
        if marks is not None:
            marks("forward")
        loss.backward()
        if marks is not None:
            marks("backward")
        ts.optimizer.step()
        if marks is not None:
            marks("adam")
        ts.model_state = tree_map(torch.Tensor.detach, new_state)
        ts.step += 1
        return ts, loss.detach()

    return step


def make_eval_step(model_config: GINConfig, loss_fn: Callable):
    """Loss only, in inference mode (no dropout, batch norm's running
    statistics, no gradients): ``eval_step(ts, batch) -> loss``."""

    @torch.no_grad()
    def eval_step(ts: TrainState, batch):
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
