"""``ginfinity-embed`` — graph embeddings from dot-bracket structures.

Port of ``ginfinity_tpu/pipelines/embed.py``: the same flags and
defaults, the same TSV schema (``embedding_vector`` as comma-joined
``%.6f`` strings, window columns first).  Two modes run on the GPU, or
on the CPU with ``--device cpu``: whole-structure graph embeddings (the
default) and the fused sliding-window mode (``--window-size``).  The
other modes raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import (
    Table,
    log_information,
    setup_and_read_input,
    write_tsv,
)


def format_embedding(vec) -> str:
    return ",".join(map("{:.6f}".format, np.asarray(vec).ravel().tolist()))


def generate_embeddings(
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
    """One graph embedding per valid structure: the id column, then
    ``window_start``/``window_end`` when present, ``embedding_vector``,
    and the other kept columns sorted.  With no valid structure the TSV
    holds the header alone."""
    from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures

    final_keep = [id_column]
    if "seq_len" in input_table.columns:
        final_keep.append("seq_len")
    if keep_cols:
        final_keep.extend(keep_cols)

    engine = InferenceEngine.from_checkpoint(model_path, device=device,
                                             max_nodes_per_batch=batch_nodes)
    cfg = engine.config
    graph_encoding = (graph_encoding_override or cfg.graph_encoding or "standard").lower()
    if graph_encoding not in {"standard", "forgi"}:
        raise ValueError(f"Unsupported graph encoding '{graph_encoding}'")
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

    if not pre.graphs:
        # the promised file exists with its header, so a later step fails
        # on its content (no rows), not on a missing file
        print("No valid structures to process.")
        write_tsv(output_path, final_keep + ["embedding_vector"], [])
        log_information(log_path, {"num_embeddings": 0}, "generate_embeddings")
        return

    embeddings = engine.embed_graphs(pre.graphs)

    rows = []
    for k, pos in enumerate(pre.kept_indices):
        base = input_table.rows[pos]
        out = {c: base[c] for c in final_keep if c in base}
        out["embedding_vector"] = format_embedding(embeddings[k])
        rows.append(out)

    present = []
    for r in rows:
        present += [c for c in r if c not in present]
    cols = [id_column] + [c for c in ("window_start", "window_end") if c in present]
    cols.append("embedding_vector")
    write_tsv(output_path, cols + sorted(c for c in present if c not in cols), rows)
    log_information(log_path, {"num_embeddings": len(rows)}, "generate_embeddings")
    if not quiet:
        print(f"Embeddings saved to {output_path}")


def generate_window_embeddings(
    input_table: Table,
    output_path: str,
    model_path: str,
    log_path: str | None,
    structure_column: str,
    id_column: str,
    window_size: int,
    keep_paired_neighbors: bool = True,
    mask_threshold: float = 0.0,
    keep_cols: list | None = None,
    quiet: bool = False,
    max_programs: int | None = None,
    wire: str | None = None,
    device=None,
):
    """Fused sliding-window embedding (--window-size): every window of
    every structure is built and embedded on the device in one pass.
    One row per window: window_id, the id column, window_start,
    window_end, seq_len, embedding_vector, then the kept columns."""
    from ginfinity_tpu_torch.models.checkpoint import load_checkpoint
    from ginfinity_tpu_torch.models.gine import GINModel
    from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows

    dev = resolve_device(device)
    cfg, params, state, _ = load_checkpoint(model_path)
    model = GINModel(cfg, params, state).to(dev)

    structures, ids = [], []
    for rid, s in zip(input_table.column(id_column), input_table.column(structure_column)):
        # invalid rows are logged and skipped, not fatal
        if not isinstance(s, str) or pair_table(s, strict=False) is None:
            log_information(log_path, {"skipped_invalid_structure": f"ID {rid}"})
            continue
        structures.append(s)
        ids.append(rid)
    results = embed_corpus_windows(
        model, structures, window_size, keep_paired_neighbors, mask_threshold,
        max_programs=max_programs, wire=wire, device=dev,
    )
    base_by_id: dict = {}
    if keep_cols:
        for r in input_table.rows:
            base_by_id.setdefault(r[id_column], r)
    rows = []
    for rid, struct, (starts, embs) in zip(ids, structures, results):
        base = base_by_id.get(rid)
        for start, vec in zip(starts.tolist(), embs):
            row = {
                "window_id": f"{rid}_{start}",
                id_column: rid,
                "window_start": start,
                "window_end": start + window_size - 1,
                "seq_len": len(struct),
                "embedding_vector": format_embedding(vec),
            }
            if base is not None:
                row.update({c: base[c] for c in keep_cols if c in base})
            rows.append(row)
    leading = ["window_id", id_column, "window_start", "window_end", "seq_len",
               "embedding_vector"]
    columns = list(leading)
    if rows:
        for r in rows:
            columns += [c for c in r if c not in columns]
    write_tsv(output_path, columns, rows)
    log_information(log_path, {
        "num_window_embeddings": len(rows),
        "window_size": window_size,
        "keep_paired_neighbors": keep_paired_neighbors,
        "mask_threshold": mask_threshold,
    }, "generate_window_embeddings")
    if not quiet:
        print(f"Window embeddings saved to {output_path}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate embeddings from precomputed graphs or raw dot-bracket TSV (PyTorch/CUDA)."
    )
    parser.add_argument("--input", help="Path to raw TSV/CSV with dot-bracket structures.")
    parser.add_argument("--graph-pt", help="Path to windows_graphs.npz (or reference .pt)")
    parser.add_argument("--meta-tsv", help="Path to windows_metadata.tsv")
    parser.add_argument("--output", required=True, help="Output TSV for embeddings.")
    parser.add_argument("--model-path", default=None,
                        help="Path to a GIN checkpoint (.pth or native .zip). Required.")
    parser.add_argument("--id-column", required=True)
    parser.add_argument("--structure-column-name", default="secondary_structure")
    parser.add_argument("--keep-cols", default=None)
    parser.add_argument("--device", default=None,
                        help="Device to run on: the CUDA device when not given, "
                             "'cpu' only when asked.")
    parser.add_argument("--num-workers", type=int, default=4,
                        help="Host preprocessing workers (reference CLI compatibility).")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="Reference CLI compatibility; superseded by --batch-nodes.")
    parser.add_argument("--batch-nodes", type=int, default=8192,
                        help="Max real nodes per device batch (bucketed padding).")
    parser.add_argument("--graph-encoding", choices=["standard", "forgi"], default=None)
    parser.add_argument("--seq-weight", type=float, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--profile-dir", default=None,
                        help="Write a profiler trace of the run to this directory.")
    parser.add_argument("--window-size", type=int, default=None,
                        help="Fused mode: embed every sliding window of this "
                             "length directly on the device.")
    parser.add_argument("--keep-paired-neighbors", action="store_true",
                        help="With --window-size: pull out-of-window "
                             "pairing partners into each window.")
    parser.add_argument("--mask-threshold", type=float, default=0.0,
                        help="With --window-size: skip windows whose "
                             "paired-base fraction is below this.")
    parser.add_argument("--max-programs", type=int, default=None,
                        help="With --window-size: merge the smallest length "
                             "buckets until at most this many groups remain.")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard the work over all visible devices.")
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32",
                        help="Product precision; f32 (default) keeps the "
                             "reference's float32 numbers.")
    parser.add_argument("--wire", choices=["f32", "f16"], default=None,
                        help="With --window-size: encoding of the embedding "
                             "download. f32 is exact; f16 halves the bytes at "
                             "<=4.9e-4 relative rounding.")
    parser.add_argument("--bf16-check", type=int, default=0, metavar="N",
                        help="With --precision bf16 and --window-size: "
                             "re-embed ~N sampled windows at f32 and log the "
                             "cosine agreement. 0 (default) disables.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.wire == "f16" and args.window_size is None:
        sys.exit("ERROR: --wire f16 requires --window-size (it is the encoding "
                 "of the fused window-embedding download).")
    if args.profile_dir:
        raise NotImplementedError("--profile-dir is not ported yet (ROADMAP queue 1, item 4)")
    if args.precision == "bf16" or args.bf16_check:
        raise NotImplementedError(
            "--precision bf16 and --bf16-check are not ported yet (ROADMAP queue 1, item 4)"
        )
    device = resolve_device(args.device)
    if args.model_path is None:
        sys.exit("ERROR: no --model-path given. Pass --model-path "
                 "(a reference .pth works directly).")
    if bool(args.graph_pt) != bool(args.meta_tsv):
        sys.exit("ERROR: --graph-pt and --meta-tsv must be given together.")
    if args.data_parallel:
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                "--data-parallel over several cards is not ported yet "
                "(ROADMAP queue 1, item 11)"
            )
        if not args.quiet:
            print("[generate_embeddings] --data-parallel: single device "
                  "visible; running unsharded")
    if args.graph_pt:
        raise NotImplementedError(
            "--graph-pt embedding is not ported yet (ROADMAP queue 1, item 6)"
        )

    table, log_path, propagate = setup_and_read_input(args, need_model=True)
    if args.window_size is None:
        generate_embeddings(
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
        return
    if args.window_size < 2:
        sys.exit("ERROR: --window-size must be >= 2.")
    generate_window_embeddings(
        input_table=table,
        output_path=args.output,
        model_path=args.model_path,
        log_path=log_path,
        structure_column=args.structure_column_name,
        id_column=args.id_column,
        window_size=args.window_size,
        keep_paired_neighbors=args.keep_paired_neighbors,
        mask_threshold=args.mask_threshold,
        keep_cols=propagate,
        quiet=args.quiet,
        max_programs=args.max_programs,
        wire=None if args.wire in (None, "f32") else args.wire,
        device=device,
    )


if __name__ == "__main__":
    main()
