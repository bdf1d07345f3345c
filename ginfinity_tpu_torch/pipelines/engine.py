"""Batched node-embedding inference over a trained GINE model.

Port of ``ginfinity_tpu/pipelines/engine.py``: host-side graph
preprocessing, feature-width adaptation, and size-ordered greedy packing
into padded batches (``graphs/batching.py``).  Each planned batch is one
:class:`GraphBatch` moved to the device and run.  Graph embeddings
(``embed_graphs``) stay on the device until the last batch and come down
in one copy; node embeddings come down batch by batch.  The JAX
package's wire format, stacked ``lax.map`` groups, backend warm-up and
``mesh`` are XLA machinery with no counterpart here (several cards:
ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.batching import batch_graphs, bucket_sizes, plan_batches, _round_capacity
from ginfinity_tpu_torch.graphs.build import GraphArrays, _fit_width, build_graph_arrays
from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.utils.device import disable_tf32, resolve_device


@dataclasses.dataclass
class PreprocessResult:
    graphs: list[GraphArrays]
    kept_indices: list[int]  # positions in the input list that were valid
    skipped: list[tuple[int, str]]  # (position, reason)


def preprocess_structures(
    structures: Sequence,
    sequences: Sequence | None = None,
    graph_encoding: str = "standard",
    seq_weight: float = 0.0,
    feature_dim: int | None = None,
) -> PreprocessResult:
    """Validate and build graph arrays for a list of structures; an
    invalid or missing structure is skipped with its reason."""
    graphs: list[GraphArrays] = []
    kept: list[int] = []
    skipped: list[tuple[int, str]] = []
    for i, s in enumerate(structures):
        if not isinstance(s, str) or pair_table(s, strict=False) is None:
            skipped.append((i, "invalid_dot_bracket"))
            continue
        seq = sequences[i] if sequences is not None else None
        if seq is not None and not isinstance(seq, str):
            seq = None
        try:
            ga = build_graph_arrays(
                s, seq, seq_weight=seq_weight, graph_encoding=graph_encoding,
                feature_dim=feature_dim,
            )
        except ValueError:
            skipped.append((i, "graph_build_failed"))
            continue
        graphs.append(ga)
        kept.append(i)
    return PreprocessResult(graphs, kept, skipped)


def adapt_feature_dim(graphs: Sequence[GraphArrays], feature_dim: int) -> list[GraphArrays]:
    """Truncate or zero-pad node features to a checkpoint's input width."""
    return [g if g.node_feat.shape[1] == feature_dim else dataclasses.replace(
        g, node_feat=np.ascontiguousarray(_fit_width(g.node_feat, feature_dim)))
        for g in graphs]


def adapt_graphs_to_model(graphs: Sequence[GraphArrays], cfg: GINConfig) -> list[GraphArrays]:
    """Feature-width adaptation, plus the forgi layout for standard graphs
    fed to a forgi model: node rows in ``[4 struct, 4 seq, is_base, 7
    type]`` with ``is_base=1`` for bases, and 4-wide edge attributes
    ``[adj, bp, fwd, bwd]`` moved to columns 0, 1, 5, 6 of 7."""
    forgi = (cfg.graph_encoding or "standard").lower() == "forgi"
    out = []
    for g in graphs:
        f, ea = g.node_feat, g.edge_attr
        if forgi and f.shape[1] <= 8 < cfg.node_feature_dim:
            nf = np.zeros((f.shape[0], cfg.node_feature_dim), np.float32)
            c = min(f.shape[1], 8)
            nf[:, :c] = f[:, :c]
            nf[: g.n_base_nodes, 8] = 1.0
            f = nf
        if ea.shape[1] == 4 and cfg.edge_feature_dim == 7:
            na = np.zeros((ea.shape[0], 7), np.float32)
            na[:, :2] = ea[:, :2]
            na[:, 5:7] = ea[:, 2:4]
            ea = na
        if f is not g.node_feat or ea is not g.edge_attr:
            g = dataclasses.replace(
                g,
                node_feat=np.ascontiguousarray(f),
                edge_attr=np.ascontiguousarray(ea),
            )
        out.append(g)
    return adapt_feature_dim(out, cfg.node_feature_dim)


class InferenceEngine:
    """Bucketed batched inference over a GINE model on one device."""

    def __init__(self, model: GINModel, max_nodes_per_batch: int = 8192,
                 max_graphs_per_batch: int = 256, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.model = model.to(self.device)
        self.max_nodes_per_batch = max_nodes_per_batch
        self.max_graphs_per_batch = max_graphs_per_batch

    @classmethod
    def from_checkpoint(cls, path: str, device=None, **kw) -> "InferenceEngine":
        from ginfinity_tpu_torch.models.checkpoint import load_checkpoint

        config, params, state, _ = load_checkpoint(path)
        return cls(GINModel(config, params, state), device=device, **kw)

    @property
    def config(self) -> GINConfig:
        return self.model.config

    def _plan(self, graphs: Sequence[GraphArrays]) -> list[list[int]]:
        return plan_batches(graphs, self.max_nodes_per_batch, self.max_graphs_per_batch)

    def _batches(self, graphs: Sequence[GraphArrays]):
        """``(idxs, batch)`` for each planned batch, in plan order."""
        for idxs in self._plan(graphs):
            chunk = [graphs[i] for i in idxs]
            n_cap, e_cap = bucket_sizes(sum(g.n_nodes for g in chunk),
                                        sum(g.n_edges for g in chunk))
            yield idxs, batch_graphs(chunk, n_cap, e_cap, _round_capacity(len(chunk)))

    def embed_graphs(self, graphs: Sequence[GraphArrays]) -> np.ndarray:
        """Graph embeddings ``[len(graphs), output_dim]`` float32, in input
        order."""
        out = np.zeros((len(graphs), self.config.output_dim), np.float32)
        order, parts = [], []
        for idxs, batch in self._batches(graphs):
            parts.append(self.model.forward_once(batch)[: len(idxs)])
            order += idxs
        if parts:
            out[order] = torch.cat(parts).cpu().numpy()
        return out

    def node_embeddings(self, graphs: Sequence[GraphArrays],
                        base_only: bool = True) -> list[np.ndarray]:
        """Per-graph ``[L_i, D]`` node-embedding matrices, in input order;
        ``base_only`` drops non-base (forgi meta) nodes."""
        results: list[np.ndarray | None] = [None] * len(graphs)
        for idxs, batch in self._batches(graphs):
            xs = self.model.get_node_embeddings(batch).cpu().numpy()
            off = 0
            for gi in idxs:
                g = graphs[gi]
                take = g.n_base_nodes if base_only else g.n_nodes
                results[gi] = xs[off: off + take].copy()
                off += g.n_nodes
        return results  # type: ignore[return-value]
