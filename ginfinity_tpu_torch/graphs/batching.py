"""Padded batches of flat graphs for the encoder.

Port of ``ginfinity_tpu/graphs/batching.py``.  Graphs are packed into
one :class:`GraphBatch` padded to capacities from a ladder, in segment
form:

  - ``node_feat  [N_pad, F]`` node features, zero-padded
  - ``node_graph [N_pad]``    graph id per node; padding rows point at
    the trash segment ``num_graphs``
  - ``node_mask``, ``base_mask [N_pad]`` real nodes, real base nodes
  - ``edge_src/edge_dst [E_pad]`` directed edges; padding edges point at
    node 0 and are masked by ``edge_mask``, not dropped
  - ``edge_attr  [E_pad, Fe]`` zero-padded
  - ``n_nodes    [G]``        real node count per graph

The JAX package's compressed wire format (``batch_graphs_wire``,
``decode_wire``) shrank transfers to a remote TPU and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.build import GraphArrays

_LADDER = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
           4096, 6144, 8192, 12288, 16384)


def _round_capacity(n: int) -> int:
    """Smallest ladder rung holding ``n``; beyond the ladder, the next
    multiple of 4096."""
    for c in _LADDER:
        if n <= c:
            return c
    return ((n + 4095) // 4096) * 4096


def bucket_sizes(n_nodes: int, n_edges: int) -> tuple[int, int]:
    """Padded (node, edge) capacities for a batch."""
    return _round_capacity(max(1, n_nodes)), _round_capacity(max(1, n_edges))


@dataclasses.dataclass
class GraphBatch:
    node_feat: torch.Tensor  # [N_pad, F] float32
    node_graph: torch.Tensor  # [N_pad] int32 (padding rows = num_graphs)
    node_mask: torch.Tensor  # [N_pad] float32
    base_mask: torch.Tensor  # [N_pad] float32 (1 for base nodes)
    edge_src: torch.Tensor  # [E_pad] int32
    edge_dst: torch.Tensor  # [E_pad] int32
    edge_attr: torch.Tensor  # [E_pad, Fe] float32
    edge_mask: torch.Tensor  # [E_pad] float32
    n_nodes: torch.Tensor  # [G] int32 real nodes per graph
    num_graphs: int

    @property
    def num_nodes_padded(self) -> int:
        return self.node_feat.shape[0]

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_graphs"
        })


def batch_graphs(
    graphs: Sequence[GraphArrays],
    node_capacity: int | None = None,
    edge_capacity: int | None = None,
    graph_capacity: int | None = None,
) -> GraphBatch:
    """Pack graphs into one padded batch of CPU tensors.
    ``graph_capacity`` pads the graph count too; pooled rows
    ``>= len(graphs)`` are padding."""
    g = graph_capacity or len(graphs)
    if len(graphs) > g:
        raise ValueError(f"{len(graphs)} graphs exceed graph_capacity {g}")
    total_nodes = sum(x.n_nodes for x in graphs)
    total_edges = sum(x.n_edges for x in graphs)
    n_cap = node_capacity or bucket_sizes(total_nodes, total_edges)[0]
    e_cap = edge_capacity or bucket_sizes(total_nodes, total_edges)[1]
    if total_nodes > n_cap or total_edges > e_cap:
        raise ValueError(
            f"batch needs ({total_nodes} nodes, {total_edges} edges), "
            f"capacity is ({n_cap}, {e_cap})"
        )

    k = len(graphs)
    nn_arr = np.fromiter((x.n_nodes for x in graphs), np.int64, k)
    ne_arr = np.fromiter((x.n_edges for x in graphs), np.int64, k)
    nb_arr = np.fromiter((x.n_base_nodes for x in graphs), np.int64, k)
    n_off = np.zeros(k, np.int64)
    np.cumsum(nn_arr[:-1], out=n_off[1:])

    def pad_rows(x, cap):
        r = cap - x.shape[0]
        if r == 0:
            return x
        return np.concatenate([x, np.zeros((r,) + x.shape[1:], x.dtype)])

    node_feat = pad_rows(np.concatenate([x.node_feat for x in graphs]), n_cap)
    node_graph = pad_rows(np.repeat(np.arange(k, dtype=np.int32), nn_arr), n_cap)
    node_graph[total_nodes:] = g  # trash segment
    node_mask = np.zeros(n_cap, np.float32)
    node_mask[:total_nodes] = 1.0
    pos_in_graph = np.arange(total_nodes, dtype=np.int64) - np.repeat(n_off, nn_arr)
    base_mask = np.zeros(n_cap, np.float32)
    base_mask[:total_nodes] = (pos_in_graph < np.repeat(nb_arr, nn_arr)).astype(np.float32)

    e_shift = np.repeat(n_off, ne_arr).astype(np.int32)
    edge_src = pad_rows(np.concatenate([x.edge_src for x in graphs]) + e_shift, e_cap)
    edge_dst = pad_rows(np.concatenate([x.edge_dst for x in graphs]) + e_shift, e_cap)
    edge_attr = pad_rows(np.concatenate([x.edge_attr for x in graphs]), e_cap)
    edge_mask = np.zeros(e_cap, np.float32)
    edge_mask[:total_edges] = 1.0
    n_nodes = np.zeros(g, np.int32)  # padded graph slots stay 0
    n_nodes[:k] = nn_arr
    t = torch.from_numpy
    return GraphBatch(
        node_feat=t(np.ascontiguousarray(node_feat, np.float32)),
        node_graph=t(node_graph.astype(np.int32)),
        node_mask=t(node_mask),
        base_mask=t(base_mask),
        edge_src=t(edge_src.astype(np.int32)),
        edge_dst=t(edge_dst.astype(np.int32)),
        edge_attr=t(np.ascontiguousarray(edge_attr, np.float32)),
        edge_mask=t(edge_mask),
        n_nodes=t(n_nodes),
        num_graphs=g,
    )


def plan_batches(
    graphs: Sequence[GraphArrays],
    max_nodes_per_batch: int = 8192,
    max_graphs_per_batch: int = 512,
) -> list[list[int]]:
    """Greedy packing of graph indices, in size order, into batches
    bounded by node count and graph count; callers keep the index lists
    to restore the input order."""
    order = sorted(range(len(graphs)), key=lambda i: graphs[i].n_nodes)
    batches: list[list[int]] = []
    cur: list[int] = []
    cur_nodes = 0
    for i in order:
        n = graphs[i].n_nodes
        if cur and (cur_nodes + n > max_nodes_per_batch or len(cur) >= max_graphs_per_batch):
            batches.append(cur)
            cur = []
            cur_nodes = 0
        cur.append(i)
        cur_nodes += n
    if cur:
        batches.append(cur)
    return batches
