"""GINE encoder configuration, parameters and shared layer helpers.

Port of the parts of ``ginfinity_tpu/models/gine.py`` that the windowed
embedding path and the node-embedding path use.  Parameters keep the JAX package's tree layout —
nested dicts with ``[in, out]`` dense kernels — so the fused window
forward reads like its JAX counterpart and a JAX parameter tree carries
over key for key (``models/checkpoint.py::params_from_jax``).

Layer semantics (PyG parity):
  GINEConv:  ``out = MLP((1 + eps) * x + sum_{j->i} relu(x_j + W_e e_ji + b_e))``
  GraphNorm: ``y = w * (x - a * mean_g) / sqrt(var_g(x - a * mean_g) + 1e-5) + b``
  node_embed_norm 'zscore_l2': z-score with the ``node_mu``/``node_sigma``
  buffers, then row L2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ginfinity_tpu_torch.graphs.batching import GraphBatch
from ginfinity_tpu_torch.graphs.build import FORGI_NODE_TYPES

Params = dict
State = dict

_NORM_EPS = 1e-5  # PyG GraphNorm eps


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

    @property
    def gin_layers(self) -> int:
        return len(self.hidden_dims)

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
    if config.pooling_type == "set2set":
        raise NotImplementedError(
            "set2set pooling is not ported yet (ROADMAP queue 1, item 2)"
        )
    params["fc"] = _init_linear(generator, config.hidden_dims[-1], config.output_dim)
    last = config.hidden_dims[-1]
    state: State = {"node_mu": torch.zeros(last), "node_sigma": torch.ones(last)}
    return params, state


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


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


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` as ``index_add_`` into zeros."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


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
    out = x - mean[batch.node_graph] * p["mean_scale"]
    var = _segment_mean(out * out, batch, counts)
    std = torch.sqrt(var + _NORM_EPS)
    return p["weight"] * out / std[batch.node_graph] + p["bias"]


def encode_nodes(config: GINConfig, params: Params, state: State, batch: GraphBatch,
                 *, train: bool = False) -> torch.Tensor:
    """The GINE stack in inference mode; raw node embeddings [N_pad, D].

    Each layer: ``msg = relu(x[src] + edge_lin(attr)) * edge_mask``
    summed into ``dst``; ``h = (1 + eps) x + agg``; a 2-layer ReLU MLP;
    GraphNorm (or none); the residual when the widths match."""
    if train:
        raise NotImplementedError(
            "training mode and dropout are not ported yet (ROADMAP queue 1, item 2)"
        )
    if config.norm_type not in ("graph", "none"):
        raise NotImplementedError(
            f"norm_type {config.norm_type!r} is not ported yet (ROADMAP queue 1, item 2)"
        )
    x = _dense(batch.node_feat, params["node_encoder"])
    for i in range(config.gin_layers):
        conv = params["convs"][i]
        h_in = x
        edge_emb = _dense(batch.edge_attr, conv["edge_lin"])
        msg = torch.relu(x[batch.edge_src] + edge_emb) * batch.edge_mask[:, None]
        agg = _segment_sum(msg, batch.edge_dst, batch.num_nodes_padded)
        h = (1.0 + conv["eps"]) * x + agg
        h = torch.relu(_dense(h, conv["mlp0"]))
        h = torch.relu(_dense(h, conv["mlp1"]))
        if config.norm_type == "graph":
            h = _graph_norm(h, params["norms"][i], batch)
        if config.use_residual and h_in.shape == h.shape:
            h = h + h_in
        x = h
    return x


def get_node_embeddings(config: GINConfig, params: Params, state: State,
                        batch: GraphBatch, *, apply_norm: bool = True,
                        train: bool = False) -> torch.Tensor:
    """Node embeddings [N_pad, D], node-normalised when ``apply_norm``."""
    x = encode_nodes(config, params, state, batch, train=train)
    if apply_norm:
        x = apply_node_norm(config, state, x)
    return x


def listify(node):
    """Turn dicts keyed "0".."n-1" of a nested tree into lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        return [listify(node[str(i)]) for i in range(len(keys))]
    return {k: listify(v) for k, v in node.items()}


class GINModel(nn.Module):
    """A config with its parameters and ``node_mu``/``node_sigma`` state.

    The tensors are registered on the module (so ``.to(device)`` moves
    them); :attr:`params` and :attr:`state` give them back in the JAX
    package's tree layout, which the forward functions read.
    """

    def __init__(self, config: GINConfig, params: Params, state: State):
        super().__init__()
        extra = set(state) - {"node_mu", "node_sigma"}
        if extra or "set2set" in params:
            raise NotImplementedError(
                "batch-norm state and set2set pooling are not ported yet "
                "(ROADMAP queue 1, item 2)"
            )
        self.config = config
        self._keys: list[tuple[str, ...]] = []
        as_t = lambda v: torch.as_tensor(v, dtype=torch.float32)

        def register(path, tree):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    register(path + (k,), v)
            elif isinstance(tree, (list, tuple)):
                for i, v in enumerate(tree):
                    register(path + (str(i),), v)
            else:
                self.register_parameter(
                    "__".join(path), nn.Parameter(as_t(tree).clone(), requires_grad=False)
                )
                self._keys.append(path)

        self._n_layers = config.gin_layers
        register((), params)
        self.register_buffer("node_mu", as_t(state["node_mu"]).clone())
        self.register_buffer("node_sigma", as_t(state["node_sigma"]).clone())
        self._packed: dict = {}

    @property
    def params(self) -> Params:
        tree: dict = {}
        for path in self._keys:
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = getattr(self, "__".join(path)).detach()

        out = listify(tree)
        # layers without norm parameters (norm_type 'none') hold no tensors
        norms = out.get("norms", [])
        out["norms"] = norms + [{}] * (self._n_layers - len(norms))
        return out

    @property
    def state(self) -> State:
        return {"node_mu": self.node_mu, "node_sigma": self.node_sigma}

    @property
    def device(self) -> torch.device:
        return self.node_mu.device

    @torch.no_grad()
    def get_node_embeddings(self, batch: GraphBatch, apply_norm: bool = True) -> torch.Tensor:
        """Node embeddings of a batch on the model's device."""
        return get_node_embeddings(self.config, self.params, self.state,
                                   batch.to(self.device), apply_norm=apply_norm)

    def packed_windows(self):
        """The window kernel's flat parameter buffer for the model's
        current device, packed once and reused."""
        from ginfinity_tpu_torch.ops.windows_encoder import pack_params

        key = str(self.device)
        if key not in self._packed:
            self._packed = {key: pack_params(self.config, self.params, self.state)}
        return self._packed[key]
