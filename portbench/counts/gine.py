"""FLOPs of the GINE stack, counted from real (unpadded) rows.

Two FLOPs a multiply-add, for the dense products on node rows: the node
encoder, each layer's two MLP products and the fc head on pooled rows.
The edge products (``W_e attr``, a few distinct rows a layer) and the
elementwise work are left out: they are under 2% of the products at
these widths, and an implementation may hoist them.
"""

from __future__ import annotations


def layer_widths(cfg: dict) -> list[tuple[int, int]]:
    hd = cfg["hidden_dims"]
    return [(hd[i - 1] if i else hd[0], d) for i, d in enumerate(hd)]


def mlp_flops(cfg: dict, rows: float) -> float:
    """Each layer's two MLP products over ``rows`` node rows."""
    return 2.0 * rows * sum(a * b + b * b for a, b in layer_widths(cfg))


def encoder_flops(cfg: dict, rows: float) -> float:
    return 2.0 * rows * cfg["node_feature_dim"] * cfg["hidden_dims"][0]


def head_flops(cfg: dict, graphs: float) -> float:
    return 2.0 * graphs * cfg["hidden_dims"][-1] * cfg["output_dim"]


def forward_flops(cfg: dict, rows: float, graphs: float) -> float:
    """One inference forward of ``graphs`` graphs holding ``rows`` nodes."""
    return encoder_flops(cfg, rows) + mlp_flops(cfg, rows) + head_flops(cfg, graphs)


def train_step_flops(cfg: dict, rows: float, subset: float) -> float:
    """One alignment-mode training step over ``rows`` nodes and a mined
    subset of ``subset`` nodes: the forward of the node embeddings (no
    head: the loss reads nodes), the loss's ``M x M`` cosine product, and
    the backward, twice the forward's products (the input's and the
    weight's gradients) except the node encoder's, whose input needs no
    gradient."""
    d = cfg["hidden_dims"][-1]
    fwd = encoder_flops(cfg, rows) + mlp_flops(cfg, rows) + 2.0 * subset * subset * d
    bwd = encoder_flops(cfg, rows) + 2.0 * (mlp_flops(cfg, rows) + 2.0 * subset * subset * d)
    return fwd + bwd
