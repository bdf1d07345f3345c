"""GINE encoder configuration, parameters and shared layer helpers.

Port of ``ginfinity_tpu/models/gine.py``: every norm type (graph, layer,
instance, batch with running state, none) and every pooling (add, mean,
Set2Set), in inference and in train mode (dropout from an explicit
``torch.Generator``, batch norm's batch statistics and running update,
``fit_node_stats``).  Parameters keep the JAX package's tree
layout — nested dicts with ``[in, out]`` dense kernels — so the fused
window forward reads like its JAX counterpart and a JAX parameter tree
carries over key for key (``models/checkpoint.py::params_from_jax``).

Layer semantics (PyG parity):
  GINEConv:  ``out = MLP((1 + eps) * x + sum_{j->i} relu(x_j + W_e e_ji + b_e))``
  GraphNorm: ``y = w * (x - a * mean_g) / sqrt(var_g(x - a * mean_g) + 1e-5) + b``
  LayerNorm (graph mode): one mean and variance per graph over all its
  ``nodes x features`` entries, then the affine.
  InstanceNorm: per-graph, per-feature statistics, no affine.
  BatchNorm: the checkpoint's ``running_mean``/``running_var``; in train
  mode the batch's statistics over real nodes, and the running update.
  Set2Set: two steps of a torch-layout LSTM (gates i, f, g, o) with
  attention over each graph's nodes.
  node_embed_norm 'zscore_l2': z-score with the ``node_mu``/``node_sigma``
  buffers, then row L2.

Every gather with repeated indices and every segment sum goes through
:class:`_Gather` and :class:`_SegmentSum`, whose backward passes are each
other: the gradient of a gather is summed in index order, on the card as
on the CPU, never by the card's atomic ``index_add_``, so two runs of a
train step give the same gradients bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from ginfinity_tpu_torch.graphs.batching import GraphBatch
from ginfinity_tpu_torch.graphs.build import FORGI_NODE_TYPES

Params = dict
State = dict

_NORM_EPS = 1e-5  # PyG GraphNorm/LayerNorm/InstanceNorm/BatchNorm eps
_SET2SET_STEPS = 2  # processing steps of the reference's Set2Set
PRECISIONS = ("highest", "bf16")


@dataclasses.dataclass(frozen=True)
class GINConfig:
    """Model hyperparameters; mirrors the reference checkpoint
    ``metadata`` schema so checkpoints round-trip."""

    hidden_dims: tuple[int, ...]
    output_dim: int
    graph_encoding: str = "standard"
    dropout: float = 0.05
    pooling_type: str = "global_add_pool"
    node_embed_norm: str = "none"  # {none,l2,zscore,zscore_l2}
    eps: float = 1e-6
    norm_type: str = "graph"  # {none,batch,graph,layer,instance}
    use_residual: bool = True
    normalize_nodes_before_pool: bool = False
    node_feature_dim: int = 4
    edge_feature_dim: int = 4
    gin_eps: float = 0.0
    train_eps: bool = True
    seq_weight: float = 0.0
    # "highest": every product in float32 (the reference's numbers).
    # "bf16": both operands of every product rounded to bfloat16, the
    # products summed in float32 (the speed mode).  A runtime choice, not
    # a property of the model: it stays out of the checkpoint metadata.
    matmul_precision: str = "highest"

    @property
    def gin_layers(self) -> int:
        return len(self.hidden_dims)

    def with_precision(self, precision: str) -> "GINConfig":
        if precision not in PRECISIONS:
            raise ValueError(f"matmul_precision must be 'highest' or 'bf16', got {precision!r}")
        return dataclasses.replace(self, matmul_precision=precision)

    @staticmethod
    def create(
        hidden_dim: int | list[int] | tuple[int, ...],
        output_dim: int,
        gin_layers: int = 1,
        graph_encoding: str = "standard",
        node_feature_dim: int | None = None,
        edge_feature_dim: int | None = None,
        **kw: Any,
    ) -> "GINConfig":
        """Constructor with the reference's defaulting rules."""
        if isinstance(hidden_dim, (int, float)):
            hidden_dims = (int(hidden_dim),) * gin_layers
        else:
            hidden_dim = list(hidden_dim)
            if len(hidden_dim) not in (1, gin_layers):
                raise ValueError(
                    f"hidden_dim list must be of length 1 or {gin_layers}, got {len(hidden_dim)}"
                )
            hidden_dims = tuple(hidden_dim * gin_layers if len(hidden_dim) == 1 else hidden_dim)
        if node_feature_dim is None:
            node_feature_dim = (
                2 + 2 + 4 + 1 + len(FORGI_NODE_TYPES) if graph_encoding == "forgi" else 4
            )
        if edge_feature_dim is None:
            edge_feature_dim = 7 if graph_encoding == "forgi" else 4
        return GINConfig(
            hidden_dims=hidden_dims,
            output_dim=output_dim,
            graph_encoding=graph_encoding,
            node_feature_dim=int(node_feature_dim),
            edge_feature_dim=int(edge_feature_dim),
            **kw,
        )

    @staticmethod
    def from_metadata(md: dict) -> "GINConfig":
        """Reconstruct from checkpoint metadata with the reference
        loader's fallback defaults, which differ from the constructor's
        (``norm_type`` -> 'none', ``use_residual`` -> False)."""
        node_feature_dim = md.get("node_feature_dim")
        edge_feature_dim = md.get("edge_feature_dim")
        if edge_feature_dim is None:
            edge_feature_dim = 4 if node_feature_dim is not None else 2
        hidden = md["hidden_dims"] if "hidden_dims" in md else md["hidden_dim"]
        return GINConfig.create(
            hidden_dim=hidden,
            output_dim=md["output_dim"],
            gin_layers=md.get("gin_layers", len(hidden) if isinstance(hidden, list) else 1),
            graph_encoding=md.get("graph_encoding", "standard"),
            dropout=md.get("dropout", 0.05),
            pooling_type=md.get("pooling_type", "global_add_pool"),
            node_embed_norm=md.get("node_embed_norm", "none"),
            eps=md.get("eps", 1e-6),
            norm_type=md.get("norm_type", "none"),
            use_residual=md.get("use_residual", False),
            normalize_nodes_before_pool=md.get("normalize_nodes_before_pool", False),
            node_feature_dim=node_feature_dim,
            edge_feature_dim=edge_feature_dim,
            gin_eps=md.get("gin_eps", 0.0),
            train_eps=md.get("train_eps", True),
            seq_weight=float(md.get("seq_weight", 0.0) or 0.0),
        )

    def to_metadata(self) -> dict:
        return {
            "hidden_dims": list(self.hidden_dims),
            "output_dim": self.output_dim,
            "graph_encoding": self.graph_encoding,
            "gin_layers": self.gin_layers,
            "dropout": self.dropout,
            "pooling_type": self.pooling_type,
            "node_embed_norm": self.node_embed_norm,
            "eps": self.eps,
            "norm_type": self.norm_type,
            "use_residual": self.use_residual,
            "normalize_nodes_before_pool": self.normalize_nodes_before_pool,
            "node_feature_dim": self.node_feature_dim,
            "edge_feature_dim": self.edge_feature_dim,
            "gin_eps": self.gin_eps,
            "train_eps": self.train_eps,
            "seq_weight": self.seq_weight,
        }


def _init_linear(generator: torch.Generator, fan_in: int, fan_out: int) -> dict:
    """torch's default Linear init (Kaiming-uniform kernel, fan-in bias
    bound), in the ``[in, out]`` kernel layout."""
    limit = math.sqrt(1.0 / fan_in)
    gain = math.sqrt(2.0 / (1.0 + 5.0))
    w_limit = gain * math.sqrt(3.0 / fan_in)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (2.0 * u - 1.0) * bound

    return {"kernel": uniform((fan_in, fan_out), w_limit), "bias": uniform((fan_out,), limit)}


def _init_lstm(generator: torch.Generator, input_size: int, hidden_size: int) -> dict:
    """torch's LSTM init, uniform in +-1/sqrt(hidden), torch layout:
    ``w_ih [4H, in]``, ``w_hh [4H, H]``, gates i, f, g, o."""
    limit = math.sqrt(1.0 / hidden_size)

    def uniform(shape):
        return (2.0 * torch.rand(shape, generator=generator) - 1.0) * limit

    return {
        "w_ih": uniform((4 * hidden_size, input_size)),
        "w_hh": uniform((4 * hidden_size, hidden_size)),
        "b_ih": uniform((4 * hidden_size,)),
        "b_hh": uniform((4 * hidden_size,)),
    }


def init_params(generator: torch.Generator, config: GINConfig) -> tuple[Params, State]:
    """Random parameters on the CPU from ``generator``, with the same
    distributions as the JAX package's ``init_params`` (the draws differ:
    the two frameworks' generators are not the same)."""
    params: Params = {
        "node_encoder": _init_linear(generator, config.node_feature_dim, config.hidden_dims[0])
    }
    convs, norms = [], []
    for i in range(config.gin_layers):
        in_dim = config.hidden_dims[i - 1] if i > 0 else config.hidden_dims[0]
        out_dim = config.hidden_dims[i]
        convs.append({
            "eps": torch.full((1,), config.gin_eps, dtype=torch.float32),
            "mlp0": _init_linear(generator, in_dim, out_dim),
            "mlp1": _init_linear(generator, out_dim, out_dim),
            "edge_lin": _init_linear(generator, config.edge_feature_dim, in_dim),
        })
        if config.norm_type == "graph":
            norms.append({
                "weight": torch.ones(out_dim),
                "bias": torch.zeros(out_dim),
                "mean_scale": torch.ones(out_dim),
            })
        elif config.norm_type in ("batch", "layer"):
            norms.append({"weight": torch.ones(out_dim), "bias": torch.zeros(out_dim)})
        else:
            norms.append({})
    params["convs"] = convs
    params["norms"] = norms
    last = config.hidden_dims[-1]
    if config.pooling_type == "set2set":
        params["set2set"] = _init_lstm(generator, 2 * last, last)
        params["fc"] = _init_linear(generator, 2 * last, config.output_dim)
    else:
        params["fc"] = _init_linear(generator, last, config.output_dim)
    state: State = {"node_mu": torch.zeros(last), "node_sigma": torch.ones(last)}
    if config.norm_type == "batch":
        state["batch_norms"] = [
            {"running_mean": torch.zeros(d), "running_var": torch.ones(d)}
            for d in config.hidden_dims
        ]
    return params, state


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest, ties to even) and back, in
    ``x``'s dtype, with the bits of JAX's ``jnp.asarray(x, jnp.bfloat16)``:
    a NaN becomes the quiet NaN of its sign.  A float64 ``x`` is rounded
    to float32 first."""
    y = x.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    y = torch.where(torch.isnan(y), torch.copysign(torch.full_like(y, float("nan")), x), y)
    return y.to(x.dtype)


# this torch's bf16 product with a float32 output (CUDA only)
_MM_DTYPE = "dtype" in torch.ops.aten.mm.overloads()


def bf16_matmul_route(device: torch.device) -> str:
    """How :func:`_matmul` computes a bf16 product on ``device``:
    ``"mm.dtype"`` (a bf16 GEMM with float32 sums and output,
    ``aten::mm.dtype``) or ``"emulation"`` (operands rounded to bf16,
    then a float32 product)."""
    return "mm.dtype" if _MM_DTYPE and device.type == "cuda" else "emulation"


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``a @ b`` (``b`` 2-D) at ``precision``.  Under ``"bf16"`` both
    operands are rounded to bfloat16 and the exact products summed in
    float32, which is the JAX package's ``Precision.DEFAULT`` on the TPU.
    Products of two bf16 values are exact in float32, so the emulation
    (rounded operands, then a float32 product) computes the same sums."""
    if precision == "highest":
        return a @ b
    if precision != "bf16":
        raise ValueError(f"matmul_precision must be 'highest' or 'bf16', got {precision!r}")
    if bf16_matmul_route(a.device) == "mm.dtype":
        a2 = a.reshape(-1, a.shape[-1]).to(torch.bfloat16)
        out = torch.mm(a2, b.to(torch.bfloat16), out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return bf16_round(a) @ bf16_round(b)


def _dense(x: torch.Tensor, p: dict, precision: str = "highest") -> torch.Tensor:
    return _matmul(x, p["kernel"], precision) + p["bias"]


def apply_node_norm(config: GINConfig, state: State, x: torch.Tensor) -> torch.Tensor:
    """Node-embedding normalisation: z-score with the buffers first,
    then row L2."""
    mode = config.node_embed_norm
    if mode == "none":
        return x
    if mode.startswith("zscore"):
        x = (x - state["node_mu"]) / (state["node_sigma"] + config.eps)
    if mode.endswith("l2"):
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        x = x / torch.clamp(norms, min=config.eps)
    return x


def _segment_add(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` into zeros, each segment summed in index
    order: ``index_add_`` on the CPU, ``_ordered_segment_sum`` on the
    card, where ``index_add_`` adds with atomics in an order that changes
    from run to run (a 6-layer GraphNorm stack carries that to ~1e-4 in
    its unit node rows)."""
    if x.is_cuda:
        return _ordered_segment_sum(x, seg, num_segments)
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


class _SegmentSum(torch.autograd.Function):
    """:func:`_segment_add` whose backward is the gather ``grad[seg]``."""

    @staticmethod
    def forward(ctx, x, seg, num_segments):
        ctx.save_for_backward(seg)
        return _segment_add(x, seg, num_segments)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        return grad.index_select(0, seg), None, None


class _Gather(torch.autograd.Function):
    """``x[idx]`` along dim 0 whose backward adds the gradient's rows back
    into ``x``'s by :func:`_segment_add`, in index order.  Autograd's own
    backward of a gather is ``index_add_``, with atomics on the card."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _segment_add(grad, idx, ctx.rows), None


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums ``[num_segments, ...]`` in index order, with an
    index-ordered backward."""
    return _SegmentSum.apply(x, seg, num_segments)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (rows), with an index-ordered backward."""
    return _Gather.apply(x, idx)


def _ordered_segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Each segment's rows gathered in index order and added one after
    another from zero by ``segment_reduce``: the CPU's ``index_add_``
    sums, bit for bit.  Rows are kept 2-D: the card adds a 2-D run of
    each column in order, a 1-D run in another order."""
    order, offsets = _segment_plan(seg, num_segments)
    rows = x.index_select(0, order).reshape(x.shape[0], math.prod(x.shape[1:]))
    out = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0, unsafe=True)
    return out.reshape((num_segments,) + tuple(x.shape[1:]))


def _segment_plan(seg: torch.Tensor, num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stable order of ``seg`` and each segment's offsets in it, kept
    on ``seg`` itself, so a batch's ``edge_dst`` and ``node_graph`` are
    sorted once per batch and not once per sum.  ``seg`` is never
    written in place."""
    plan = getattr(seg, "_segment_plan", None)
    if plan is None or plan[0] != num_segments:
        ids, order = torch.sort(seg, stable=True)
        bounds = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
        plan = (num_segments, order, torch.searchsorted(ids, bounds))
        seg._segment_plan = plan
    return plan[1], plan[2]


def _graph_counts(batch: GraphBatch) -> torch.Tensor:
    """Real-node count per graph (+ trash segment), shape [G+1]."""
    return _segment_sum(batch.node_mask, batch.node_graph, batch.num_graphs + 1)


def _segment_mean(x: torch.Tensor, batch: GraphBatch, counts: torch.Tensor) -> torch.Tensor:
    """Per-graph mean over real nodes; returns [G+1, F]."""
    s = _segment_sum(x * batch.node_mask[:, None], batch.node_graph, batch.num_graphs + 1)
    return s / torch.clamp(counts, min=1.0)[:, None]


def _graph_norm(x: torch.Tensor, p: dict, batch: GraphBatch) -> torch.Tensor:
    counts = _graph_counts(batch)
    mean = _segment_mean(x, batch, counts)
    out = x - _gather(mean, batch.node_graph) * p["mean_scale"]
    var = _segment_mean(out * out, batch, counts)
    std = torch.sqrt(var + _NORM_EPS)
    return p["weight"] * out / _gather(std, batch.node_graph) + p["bias"]


def _layer_norm_graph(x: torch.Tensor, p: dict, batch: GraphBatch) -> torch.Tensor:
    """PyG ``LayerNorm(mode='graph')``: the statistics of a graph run over
    all its ``nodes x features`` entries."""
    g1 = batch.num_graphs + 1
    counts = torch.clamp(_graph_counts(batch) * x.shape[1], min=1.0)
    mean = _segment_sum(x.sum(dim=1) * batch.node_mask, batch.node_graph, g1) / counts
    xc = x - _gather(mean, batch.node_graph)[:, None]
    var = _segment_sum((xc * xc).sum(dim=1) * batch.node_mask, batch.node_graph, g1) / counts
    out = xc / _gather(torch.sqrt(var + _NORM_EPS), batch.node_graph)[:, None]
    return out * p["weight"] + p["bias"]


def _instance_norm(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """PyG ``InstanceNorm`` (no affine): per-graph, per-feature statistics."""
    counts = _graph_counts(batch)
    xc = x - _gather(_segment_mean(x, batch, counts), batch.node_graph)
    var = _segment_mean(xc * xc, batch, counts)
    return xc / torch.sqrt(_gather(var, batch.node_graph) + _NORM_EPS)


_BN_MOMENTUM = 0.1


def _batch_norm(x: torch.Tensor, p: dict, bn_state: dict, batch: GraphBatch,
                train: bool) -> tuple[torch.Tensor, dict]:
    """``BatchNorm``: in eval the running statistics, in train the batch's
    over real nodes, with the running update (momentum 0.1, the variance
    made unbiased by ``n / (n - 1)``); then the affine.  Returns the
    output and the layer's new running state (detached)."""
    if train:
        mask = batch.node_mask[:, None]
        n = torch.clamp(batch.node_mask.sum(), min=1.0)
        mean = (x * mask).sum(dim=0) / n
        xc = x - mean
        var = (xc * xc * mask).sum(dim=0) / n
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        m = _BN_MOMENTUM
        new_state = {
            "running_mean": ((1 - m) * bn_state["running_mean"] + m * mean).detach(),
            "running_var": ((1 - m) * bn_state["running_var"] + m * unbiased).detach(),
        }
    else:
        mean, var, new_state = bn_state["running_mean"], bn_state["running_var"], bn_state
    out = (x - mean) / torch.sqrt(var + _NORM_EPS)
    return out * p["weight"] + p["bias"], new_state


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as the JAX package computes it: each entry kept
    with probability ``1 - rate`` (a uniform draw from ``generator`` below
    it) and scaled by ``1 / (1 - rate)``, the rest 0."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _encode(config: GINConfig, params: Params, state: State, batch: GraphBatch,
            train: bool, generator: torch.Generator | None) -> tuple[torch.Tensor, State]:
    """The GINE stack; raw node embeddings [N_pad, D] and the new state.

    Each layer: ``msg = relu(x[src] + edge_lin(attr)) * edge_mask``
    summed into ``dst``; ``h = (1 + eps) x + agg``; a 2-layer ReLU MLP,
    with dropout after its first layer; the layer's norm; dropout; the
    residual when the widths match.  Dropout runs in train mode with a
    ``generator`` and a positive rate, its masks drawn layer by layer."""
    prec = config.matmul_precision
    drop = train and config.dropout > 0 and generator is not None
    x = _dense(batch.node_feat, params["node_encoder"], prec)
    new_bns = []
    for i in range(config.gin_layers):
        conv = params["convs"][i]
        h_in = x
        edge_emb = _dense(batch.edge_attr, conv["edge_lin"], prec)
        msg = torch.relu(_gather(x, batch.edge_src) + edge_emb) * batch.edge_mask[:, None]
        agg = _segment_sum(msg, batch.edge_dst, batch.num_nodes_padded)
        eps = conv["eps"] if config.train_eps else conv["eps"].detach()
        h = (1.0 + eps) * x + agg
        h = torch.relu(_dense(h, conv["mlp0"], prec))
        if drop:
            h = _dropout(h, config.dropout, generator)
        h = torch.relu(_dense(h, conv["mlp1"], prec))
        norm = config.norm_type
        if norm == "graph":
            h = _graph_norm(h, params["norms"][i], batch)
        elif norm == "layer":
            h = _layer_norm_graph(h, params["norms"][i], batch)
        elif norm == "instance":
            h = _instance_norm(h, batch)
        elif norm == "batch":
            h, bn = _batch_norm(h, params["norms"][i], state["batch_norms"][i], batch, train)
            new_bns.append(bn)
        if drop:
            h = _dropout(h, config.dropout, generator)
        if config.use_residual and h_in.shape == h.shape:
            h = h + h_in
        x = h
    new_state = dict(state)
    if new_bns:
        new_state["batch_norms"] = new_bns
    return x, new_state


def encode_nodes(config: GINConfig, params: Params, state: State,
                 batch: GraphBatch) -> torch.Tensor:
    """The GINE stack in inference mode; raw node embeddings [N_pad, D]."""
    return _encode(config, params, state, batch, False, None)[0]


def encode_nodes_train(config: GINConfig, params: Params, state: State, batch: GraphBatch,
                       generator: torch.Generator | None = None
                       ) -> tuple[torch.Tensor, State]:
    """The GINE stack in train mode: batch norm on the batch's statistics,
    dropout when ``generator`` is given.  Returns the raw node embeddings
    and the new state (batch norm's running statistics updated)."""
    return _encode(config, params, state, batch, True, generator)


def get_node_embeddings(config: GINConfig, params: Params, state: State,
                        batch: GraphBatch, *, apply_norm: bool = True) -> torch.Tensor:
    """Node embeddings [N_pad, D], node-normalised when ``apply_norm``."""
    x = encode_nodes(config, params, state, batch)
    if apply_norm:
        x = apply_node_norm(config, state, x)
    return x


def get_node_embeddings_train(config: GINConfig, params: Params, state: State,
                              batch: GraphBatch, generator: torch.Generator | None = None
                              ) -> tuple[torch.Tensor, State]:
    """Node-normalised node embeddings in train mode, and the new state."""
    x, new_state = encode_nodes_train(config, params, state, batch, generator)
    return apply_node_norm(config, state, x), new_state


def _set2set(params: Params, x: torch.Tensor, batch: GraphBatch,
             precision: str = "highest") -> torch.Tensor:
    """Set2Set pooling ``[G+1, 2D]``: the LSTM's two steps written out in
    torch's layout (gates i, f, g, o).  Masked nodes score the float32
    minimum, not -inf, so a graph without real nodes (the trash segment,
    a padding slot) reads 0 and not NaN."""
    p = params["set2set"]
    g1 = batch.num_graphs + 1
    d = x.shape[1]
    seg = batch.node_graph.long()
    real = batch.node_mask > 0
    q_star = x.new_zeros((g1, 2 * d))
    h = x.new_zeros((g1, d))
    c = x.new_zeros((g1, d))
    neg_inf = torch.finfo(x.dtype).min
    for _ in range(_SET2SET_STEPS):
        gates = (_matmul(q_star, p["w_ih"].T, precision) + p["b_ih"]
                 + _matmul(h, p["w_hh"].T, precision) + p["b_hh"])
        gi, gf, gg, go = gates.chunk(4, dim=1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        e = torch.where(real, (x * _gather(h, seg)).sum(dim=1), neg_inf)
        emax = torch.full((g1,), neg_inf, dtype=x.dtype, device=x.device).scatter_reduce(
            0, seg, e, "amax", include_self=False)
        a = torch.exp(e - _gather(emax, seg)) * batch.node_mask
        asum = _segment_sum(a, batch.node_graph, g1)
        a = a / torch.clamp(_gather(asum, seg), min=1e-16)
        r = _segment_sum(a[:, None] * x, batch.node_graph, g1)
        q_star = torch.cat([h, r], dim=1)
    return q_star


def pool_and_project(config: GINConfig, params: Params, x: torch.Tensor,
                     batch: GraphBatch) -> torch.Tensor:
    """Graph pooling over real nodes, then ``fc``; ``[G, output_dim]``
    with the trash segment dropped.  Mean pooling divides by the real
    node count, at least 1."""
    if config.pooling_type == "set2set":
        pooled = _set2set(params, x, batch, config.matmul_precision)
    else:
        pooled = _segment_sum(x * batch.node_mask[:, None], batch.node_graph,
                              batch.num_graphs + 1)
        if config.pooling_type == "global_mean_pool":
            pooled = pooled / torch.clamp(_graph_counts(batch), min=1.0)[:, None]
    return _dense(pooled, params["fc"], config.matmul_precision)[: batch.num_graphs]


def forward_once(config: GINConfig, params: Params, state: State, batch: GraphBatch,
                 *, normalize_nodes_before_pool: bool | None = None) -> torch.Tensor:
    """Graph embeddings ``[G, output_dim]``: node embeddings, node-normalised
    when ``normalize_nodes_before_pool`` (default: the config's), pooled
    and projected."""
    if normalize_nodes_before_pool is None:
        normalize_nodes_before_pool = config.normalize_nodes_before_pool
    x = get_node_embeddings(config, params, state, batch,
                            apply_norm=normalize_nodes_before_pool)
    return pool_and_project(config, params, x, batch)


def forward_once_train(config: GINConfig, params: Params, state: State, batch: GraphBatch,
                       generator: torch.Generator | None = None
                       ) -> tuple[torch.Tensor, State]:
    """Graph embeddings in train mode, and the new state."""
    x, new_state = encode_nodes_train(config, params, state, batch, generator)
    if config.normalize_nodes_before_pool:
        x = apply_node_norm(config, state, x)
    return pool_and_project(config, params, x, batch), new_state


@torch.no_grad()
def fit_node_stats(config: GINConfig, params: Params, state: State, batches) -> State:
    """Streaming ``node_mu``/``node_sigma`` fit over the raw node
    embeddings of ``batches`` (each moved to the state's device): host
    numpy sums in the JAX package's order.  Returns the new state."""
    dev = state["node_mu"].device
    s = ss = None
    n = 0.0
    for b in batches:
        b = b.to(dev)
        x = encode_nodes(config, params, state, b)
        m = b.node_mask.cpu().numpy()
        xa = x.cpu().numpy() * m[:, None]
        if s is None:
            s = xa.sum(axis=0)
            ss = (xa * xa).sum(axis=0)
        else:
            s += xa.sum(axis=0)
            ss += (xa * xa).sum(axis=0)
        n += float(m.sum())
    if n == 0:
        raise RuntimeError("No nodes seen while fitting node stats.")
    mu = s / n
    var = np.clip(ss / n - mu * mu, 0.0, None)
    sigma = np.maximum(np.sqrt(var + config.eps), config.eps)
    new_state = dict(state)
    new_state["node_mu"] = torch.tensor(np.asarray(mu, np.float32), device=dev)
    new_state["node_sigma"] = torch.tensor(np.asarray(sigma, np.float32), device=dev)
    return new_state


def listify(node):
    """Turn dicts keyed "0".."n-1" of a nested tree into lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        return [listify(node[str(i)]) for i in range(len(keys))]
    return {k: listify(v) for k, v in node.items()}


def _leaves(path: tuple, tree):
    """``(path, tensor)`` of every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(path + (k,), v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(path + (str(i),), v)
    else:
        yield path, tree


class GINModel(nn.Module):
    """A config with its parameters and state (``node_mu``/``node_sigma``,
    and each layer's batch-norm running statistics).

    The tensors are registered on the module (so ``.to(device)`` moves
    them): parameters, among them Set2Set's LSTM, as frozen
    ``nn.Parameter``s and the state as buffers.  :attr:`params` and
    :attr:`state` give them back in the JAX package's tree layout, which
    the forward functions read.
    """

    def __init__(self, config: GINConfig, params: Params, state: State):
        super().__init__()
        self.config = config
        as_t = lambda v: torch.as_tensor(v, dtype=torch.float32).clone()
        self._keys = []
        for path, leaf in _leaves((), params):
            self.register_parameter("__".join(path), nn.Parameter(as_t(leaf), requires_grad=False))
            self._keys.append(path)
        self._state_keys = []
        for path, leaf in _leaves((), state):
            self.register_buffer("__".join(path), as_t(leaf))
            self._state_keys.append(path)
        self._n_layers = config.gin_layers
        self._packed: dict = {}

    def _tree(self, keys) -> dict:
        tree: dict = {}
        for path in keys:
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = getattr(self, "__".join(path)).detach()
        return listify(tree)

    @property
    def params(self) -> Params:
        out = self._tree(self._keys)
        # layers without norm parameters (norm_type 'none') hold no tensors
        norms = out.get("norms", [])
        out["norms"] = norms + [{}] * (self._n_layers - len(norms))
        return out

    @property
    def state(self) -> State:
        return self._tree(self._state_keys)

    @property
    def device(self) -> torch.device:
        return self.node_mu.device

    def replica(self, device) -> "GINModel":
        """A copy of the model on ``device``, with caches of its own."""
        return GINModel(self.config, self.params, self.state).to(device)

    @torch.no_grad()
    def get_node_embeddings(self, batch: GraphBatch, apply_norm: bool = True) -> torch.Tensor:
        """Node embeddings of a batch on the model's device."""
        return get_node_embeddings(self.config, self.params, self.state,
                                   batch.to(self.device), apply_norm=apply_norm)

    @torch.no_grad()
    def forward_once(self, batch: GraphBatch) -> torch.Tensor:
        """Graph embeddings ``[G, output_dim]`` of a batch on the model's
        device."""
        return forward_once(self.config, self.params, self.state, batch.to(self.device))

    def packed_windows(self):
        """The window kernel's flat parameter buffer for the model's
        current device and precision, packed once and reused."""
        from ginfinity_tpu_torch.ops.windows_encoder import pack_params

        key = (str(self.device), self.config.matmul_precision)
        if key not in self._packed:
            self._packed = {key: pack_params(self.config, self.params, self.state)}
        return self._packed[key]
