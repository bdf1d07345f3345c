"""The GINE encoder in plain PyTorch, float32 products, no kernels.

Written from the layer equations (PyG's ``GINEConv``, ``GraphNorm`` and
mean pooling), over a flat batch of graphs:

  msg   = relu(x[src] + W_e attr + b_e), summed into dst
  h     = MLP((1 + eps) x + agg), MLP = relu(W1 relu(W0 h + b0) + b1)
  h     = GraphNorm(h) = w * (h - a mean_g) / sqrt(var_g(h - a mean_g) + 1e-5) + b
  x     = h + x (residual, equal widths)
  node  = zscore_l2(x) = l2((x - mu) / (sigma + eps))
  graph = fc(mean over the graph's nodes of node)

Train mode drops entries after the MLP's first layer and after the norm
(kept with probability ``1 - p``, scaled by ``1 / (1 - p)``); the masks
come from the caller.  The parameter tree is the benchmark's own layout
(``weights.py``): ``[in, out]`` dense kernels.
"""

from __future__ import annotations

import numpy as np
import torch

NORM_EPS = 1e-5


def check_config(cfg: dict) -> None:
    for key, want in (("norm_type", "graph"), ("pooling_type", "global_mean_pool"),
                      ("node_embed_norm", "zscore_l2")):
        if cfg[key] != want:
            raise ValueError(f"the reference computes {key} {want!r}, not {cfg[key]!r}")


def flat_batch(graphs, device, dtype=torch.float32) -> dict:
    """Graphs (``graphs.Graph``) as one flat batch on ``device``, the
    features in ``dtype``."""
    sizes = np.array([g.n_nodes for g in graphs], np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return {
        "feat": t(np.concatenate([g.feat for g in graphs]), dtype),
        "src": t(np.concatenate([g.src + o for g, o in zip(graphs, off)]), torch.int64),
        "dst": t(np.concatenate([g.dst + o for g, o in zip(graphs, off)]), torch.int64),
        "attr": t(np.concatenate([g.attr for g in graphs]), dtype),
        "graph": t(np.repeat(np.arange(len(graphs)), sizes), torch.int64),
        "offsets": off,
        "sizes": sizes,
        "n_graphs": len(graphs),
    }


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed by segment, in float64 and then rounded to
    ``x``'s dtype: the card adds with atomics in no fixed order, and
    float64 sums make the float32 result the same in every run."""
    out = torch.zeros((n,) + x.shape[1:], dtype=torch.float64, device=x.device)
    return out.index_add(0, seg, x.double()).to(x.dtype)


def _segment_mean(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    c = torch.bincount(seg, minlength=n).to(x.dtype)
    return _segment_sum(x, seg, n) / c.clamp(min=1.0)[:, None]


def encode(cfg: dict, params: dict, b: dict, dropout=None) -> torch.Tensor:
    """Raw node embeddings ``[N, D]``.  ``dropout(h)``, when given, is
    applied at both dropout sites of every layer, in order."""
    def dense(x, p):
        return x @ p["kernel"] + p["bias"]

    x = dense(b["feat"], params["node_encoder"])
    for conv, norm in zip(params["convs"], params["norms"]):
        msg = torch.relu(x[b["src"]] + dense(b["attr"], conv["edge_lin"]))
        agg = _segment_sum(msg, b["dst"], x.shape[0])
        eps = conv["eps"] if cfg["train_eps"] else conv["eps"].detach()
        h = torch.relu(dense((1.0 + eps) * x + agg, conv["mlp0"]))
        if dropout is not None:
            h = dropout(h)
        h = torch.relu(dense(h, conv["mlp1"]))
        g, n = b["graph"], b["n_graphs"]
        centred = h - _segment_mean(h, g, n)[g] * norm["mean_scale"]
        var = _segment_mean(centred * centred, g, n)
        h = norm["weight"] * centred / torch.sqrt(var + NORM_EPS)[g] + norm["bias"]
        if dropout is not None:
            h = dropout(h)
        x = h + x if (cfg["use_residual"] and h.shape == x.shape) else h
    return x


def node_norm(cfg: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    z = (x - state["node_mu"]) / (state["node_sigma"] + cfg["eps"])
    return z / torch.linalg.vector_norm(z, dim=1, keepdim=True).clamp(min=cfg["eps"])


def node_embeddings(cfg: dict, params: dict, state: dict, b: dict) -> torch.Tensor:
    return node_norm(cfg, state, encode(cfg, params, b))


def graph_embeddings(cfg: dict, params: dict, state: dict, b: dict) -> torch.Tensor:
    x = encode(cfg, params, b)
    if cfg["normalize_nodes_before_pool"]:
        x = node_norm(cfg, state, x)
    pooled = _segment_mean(x, b["graph"], b["n_graphs"])
    return pooled @ params["fc"]["kernel"] + params["fc"]["bias"]
