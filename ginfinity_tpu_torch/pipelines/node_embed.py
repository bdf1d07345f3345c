"""``ginfinity-generate-node-embeddings`` — per-node (L x D) embeddings.

Port of ``ginfinity_tpu/pipelines/node_embed.py``: the same flags and
defaults (``--device`` picks the device: the card unless ``cpu`` is
asked for), the same TSV.  Column ``node_embeddings`` holds each RNA's
L x D matrix as compact JSON rounded to 6 decimals; non-base nodes are
dropped so rows align with base positions.  With ``--graph-pt`` and
``--meta-tsv`` the nodes of precomputed window graphs are embedded, one
row per window of the metadata TSV.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ginfinity_tpu_torch.pipelines.engine import (
    InferenceEngine,
    adapt_graphs_to_model,
    preprocess_structures,
)
from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import Table, log_information, setup_and_read_input, write_tsv
from ginfinity_tpu_torch.utils.native import parse_float_matrix


def serialize_matrix(mat: np.ndarray) -> str:
    """JSON of the matrix rounded to 6 decimals (``np.round`` on float64,
    shortest repr), byte-identical to the JAX package's."""
    rounded = np.round(np.asarray(mat, dtype=np.float64), 6).tolist()
    return json.dumps(rounded, separators=(",", ":"))


def parse_matrix(cell: str) -> np.ndarray:
    """A ``node_embeddings`` cell back to a float32 ``[L, D]`` matrix: the
    native scanner, else ``json``."""
    fast = parse_float_matrix(cell)
    if fast is not None:
        return fast
    mat = np.asarray(json.loads(cell), dtype=np.float32)
    if mat.ndim != 2:
        raise ValueError("node_embeddings must be a 2D array [L x D].")
    return mat


def generate_node_embeddings(
    input_table: Table,
    output_path: str,
    model_path: str,
    log_path: str | None,
    structure_column: str,
    id_column: str,
    batch_nodes: int = 8192,
    keep_cols: list | None = None,
    quiet: bool = False,
    graph_encoding_override: str | None = None,
    seq_weight_override: float | None = None,
    sequence_column: str = "sequence",
    device=None,
):
    """Embed every valid structure's nodes and write one row per RNA:
    the id column, ``node_embeddings``, then the kept columns sorted."""
    t0 = time.perf_counter()
    final_keep = [id_column]
    if "seq_len" in input_table.columns:
        final_keep.append("seq_len")
    if keep_cols:
        final_keep.extend(keep_cols)

    engine = InferenceEngine.from_checkpoint(model_path, device=device,
                                             max_nodes_per_batch=batch_nodes)
    cfg = engine.config
    graph_encoding = (graph_encoding_override or cfg.graph_encoding or "standard").lower()
    seq_weight = (
        float(seq_weight_override) if seq_weight_override is not None else cfg.seq_weight
    )
    seq_weight = max(0.0, min(1.0, seq_weight))

    structures = input_table.column(structure_column)
    sequences = (
        input_table.column(sequence_column) if sequence_column in input_table.columns else None
    )
    pre = preprocess_structures(
        structures, sequences,
        graph_encoding=graph_encoding, seq_weight=seq_weight,
        feature_dim=cfg.node_feature_dim,
    )
    row_ids = input_table.column(id_column)
    for pos, reason in pre.skipped:
        log_information(log_path, {f"skipped_{reason}": f"ID {row_ids[pos]}"})
    t_pre = time.perf_counter()

    if not pre.graphs:
        print("No valid structures to process.")
        return

    mats = engine.node_embeddings(pre.graphs, base_only=True)
    t_inf = time.perf_counter()

    rows = []
    for k, pos in enumerate(pre.kept_indices):
        base = input_table.rows[pos]
        out = {c: base[c] for c in final_keep if c in base}
        out["node_embeddings"] = serialize_matrix(mats[k])
        rows.append(out)

    present = []
    for r in rows:
        present += [c for c in r if c not in present]
    cols = [id_column] + [c for c in ("window_start", "window_end") if c in present]
    cols.append("node_embeddings")
    write_tsv(output_path, cols + sorted(c for c in present if c not in cols), rows)
    log_information(
        log_path,
        {
            "num_node_embeddings": len(rows),
            "preprocess_sec": round(t_pre - t0, 3),
            "inference_sec": round(t_inf - t_pre, 3),
        },
        "generate_node_embeddings",
    )
    if not quiet:
        print(f"Node embeddings saved to {output_path}")


def _node_embed_precomputed(args, device):
    """``--graph-pt`` mode: the base nodes' embeddings of each window graph,
    in the order of the metadata TSV, written beside each row's metadata."""
    from ginfinity_tpu_torch.pipelines.windows import load_precomputed, write_precomputed

    meta, graphs = load_precomputed(args.graph_pt, args.meta_tsv)
    log_path = os.path.splitext(args.output)[0] + ".log"
    open(log_path, "a").close()
    engine = InferenceEngine.from_checkpoint(args.model_path, device=device,
                                             max_nodes_per_batch=args.batch_nodes)
    mats = engine.node_embeddings(adapt_graphs_to_model(graphs, engine.config),
                                  base_only=True)
    write_precomputed(args.output, meta, args.id_column, "node_embeddings",
                      [serialize_matrix(m) for m in mats])
    log_information(log_path, {"num_node_embeddings": len(meta.rows)},
                    "generate_node_embeddings")
    print(f"Node embeddings saved to {args.output}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate per-node embeddings (L x D JSON matrices) from "
                    "dot-bracket structures (PyTorch/CUDA)."
    )
    parser.add_argument("--input", help="Path to raw TSV/CSV with dot-bracket structures.")
    parser.add_argument("--graph-pt", help="Path to windows_graphs.npz (or reference .pt)")
    parser.add_argument("--meta-tsv", help="Path to windows_metadata.tsv")
    parser.add_argument("--output", required=True)
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--id-column", required=True)
    parser.add_argument("--structure-column-name", default="secondary_structure")
    parser.add_argument("--keep-cols", default=None)
    parser.add_argument("--device", default=None,
                        help="Device to run on: the CUDA device when not given, "
                             "'cpu' only when asked.")
    parser.add_argument("--num-workers", type=int, default=4, help="Reference CLI compatibility.")
    parser.add_argument("--batch-size", type=int, default=None, help="Reference CLI compatibility.")
    parser.add_argument("--batch-nodes", type=int, default=8192)
    parser.add_argument("--graph-encoding", choices=["standard", "forgi"], default=None)
    parser.add_argument("--seq-weight", type=float, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--debug", action="store_true", help="Verbose per-stage timing logs.")
    parser.add_argument("--debug-preprocessing", dest="debug", action="store_true",
                        help="Reference flag; folds into the same verbose mode.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.model_path is None:
        sys.exit("ERROR: --model-path is required (a reference .pth works directly).")
    if bool(args.graph_pt) != bool(args.meta_tsv):
        sys.exit("ERROR: --graph-pt and --meta-tsv must be given together.")
    if args.graph_pt:
        _node_embed_precomputed(args, device)
        return

    table, log_path, propagate = setup_and_read_input(args, need_model=True)
    generate_node_embeddings(
        input_table=table,
        output_path=args.output,
        model_path=args.model_path,
        log_path=log_path,
        structure_column=args.structure_column_name,
        id_column=args.id_column,
        batch_nodes=args.batch_nodes,
        keep_cols=propagate,
        quiet=args.quiet,
        graph_encoding_override=args.graph_encoding,
        seq_weight_override=args.seq_weight,
        device=device,
    )


if __name__ == "__main__":
    main()
