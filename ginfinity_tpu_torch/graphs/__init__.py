"""Host-side graph layer: dot-bracket parsing, graph arrays, window
features and padded batches."""

from ginfinity_tpu_torch.graphs.dotbracket import is_valid_dot_bracket, loop_features, pair_table
from ginfinity_tpu_torch.graphs.build import GraphArrays, build_graph_arrays
from ginfinity_tpu_torch.graphs.batching import GraphBatch, batch_graphs, bucket_sizes

__all__ = [
    "is_valid_dot_bracket",
    "pair_table",
    "loop_features",
    "GraphArrays",
    "build_graph_arrays",
    "GraphBatch",
    "batch_graphs",
    "bucket_sizes",
]
