"""Seeded model weights, made on the device in one draw.

The tree is the GINE encoder's: ``node_encoder``, per layer ``convs[i]``
(``eps``, ``mlp0``, ``mlp1``, ``edge_lin``) and ``norms[i]`` (GraphNorm's
``weight``, ``bias``, ``mean_scale``), ``fc``; the state holds the
``node_mu``/``node_sigma`` buffers.  Dense kernels are ``[in, out]`` and
drawn as torch's default Linear init (uniform in
``+-sqrt(1/fan_in)``).  ``trained=True`` stands for a trained model:
GraphNorm's parameters, each layer's ``eps`` and the node statistics
are drawn away from their initial values.  ``trained=False`` is the
training start: the norms at 1 / 0 / 1, ``eps`` at ``gin_eps``, the node
statistics at 0 / 1.
"""

from __future__ import annotations

import math

import torch


def _shapes(cfg: dict) -> list[tuple[tuple, tuple]]:
    hd = cfg["hidden_dims"]
    out = [(("node_encoder", "kernel"), (cfg["node_feature_dim"], hd[0])),
           (("node_encoder", "bias"), (hd[0],))]
    for i, d in enumerate(hd):
        din = hd[i - 1] if i else hd[0]
        for name, (a, b) in (("mlp0", (din, d)), ("mlp1", (d, d)),
                             ("edge_lin", (cfg["edge_feature_dim"], din))):
            out += [(("convs", i, name, "kernel"), (a, b)), (("convs", i, name, "bias"), (b,))]
        out.append((("convs", i, "eps"), (1,)))
        out += [(("norms", i, k), (d,)) for k in ("weight", "bias", "mean_scale")]
    out += [(("fc", "kernel"), (hd[-1], cfg["output_dim"])), (("fc", "bias"), (cfg["output_dim"],))]
    out += [(("node_mu",), (hd[-1],)), (("node_sigma",), (hd[-1],))]
    return out


def _fan_in(path, shapes) -> int:
    if path[-1] == "kernel":
        return dict(shapes)[path][0]
    return dict(shapes)[path[:-1] + ("kernel",)][0]


def make(cfg: dict, seed: int, device, trained: bool) -> tuple[dict, dict]:
    """``(params, state)`` on ``device``, float32."""
    shapes = _shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0  # U(-1, 1)
    params: dict = {"node_encoder": {}, "convs": [{} for _ in cfg["hidden_dims"]],
                    "norms": [{} for _ in cfg["hidden_dims"]], "fc": {}}
    state: dict = {}
    off = 0
    for (path, shape), n in zip(shapes, sizes):
        v = u[off:off + n].reshape(shape)
        off += n
        last = path[-1]
        if path[0] == "norms":
            if last == "bias":
                v = 0.1 * v if trained else torch.zeros_like(v)
            else:
                v = 1.0 + 0.25 * v if trained else torch.ones_like(v)
        elif last in ("kernel", "bias"):
            v = v * math.sqrt(1.0 / _fan_in(path, shapes))
        elif last == "eps":
            v = 0.1 * v if trained else torch.full_like(v, cfg["gin_eps"])
        elif last == "node_mu":
            v = 0.1 * v if trained else torch.zeros_like(v)
        elif last == "node_sigma":
            v = 1.0 + 0.5 * v.abs() if trained else torch.ones_like(v)
        node = state if path[0] in ("node_mu", "node_sigma") else params
        for p in path[:-1]:
            node = node[p] if isinstance(node, list) else node.setdefault(p, {})
        node[last] = v.contiguous()
    return params, state


def cast(tree, dtype):
    """A weight tree with its leaves in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.detach().to(dtype)


def leaves(tree, path=()):
    """``(path string, tensor)`` of every leaf, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree
