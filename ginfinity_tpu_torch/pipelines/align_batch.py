"""``ginfinity-align-node-embeddings-batch`` — all-pairs embedding alignment.

Port of ``ginfinity_tpu/pipelines/align_batch.py``: the same flags (plus
``--device``), the same per-pair output layout and ``summary.tsv``.
Every ``--batch-size`` pairs' similarity matrices (numpy float32 on the
host) go through one call of ``ops/dp.py::affine_align_batch``: on the
card, one launch of the DP wavefront kernel.  ``--data-parallel`` is
accepted and runs on the one card (several cards: ROADMAP queue 1,
item 11).
"""

from __future__ import annotations

import argparse
import csv
import os
import re

import numpy as np
import torch

from ginfinity_tpu_torch.ops.dp import affine_align_batch
from ginfinity_tpu_torch.pipelines.align import (
    aligned_structures,
    alignment_to_tsv,
    cosine_similarity_matrix,
    save_matrix_png,
    save_matrix_tsv,
)
from ginfinity_tpu_torch.pipelines.node_embed import parse_matrix
from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import read_table_auto

SUMMARY_COLUMNS = ("id1", "id2", "n1", "n2", "score", "mode", "gap_open", "gap_extend")


def sanitize_pair_name(a: str, b: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]+", "_", f"{a}__vs__{b}")


def _write_pair_outputs(args, id1, id2, s1, s2, sim, best_score, path):
    pair_name = sanitize_pair_name(str(id1), str(id2))
    pair_dir = os.path.join(args.output_dir, pair_name)
    if args.write_alignment or args.write_matrix or args.plot_matrix:
        os.makedirs(pair_dir, exist_ok=True)
    if args.write_alignment:
        with open(os.path.join(pair_dir, f"{pair_name}.alignment.tsv"), "w") as f:
            f.write(f'# mode="{args.mode}"\n')
            f.write(f'# gap_open="{args.gap_open}"\n')
            f.write(f'# gap_extend="{args.gap_extend}"\n')
            f.write(f'# rna1="{id1}", rna2="{id2}"\n')
            f.write(f'# total_alignment_score="{best_score:.6f}"\n')
            if s1 is not None and s2 is not None:
                f.write('# aligned_structures_present="true"\n')
            f.write(alignment_to_tsv(path, sim, s1, s2))
        if s1 is not None and s2 is not None:
            a1, a2 = aligned_structures(path, s1, s2)
            with open(os.path.join(pair_dir, f"{pair_name}.structures.txt"), "w") as f:
                f.write(f"{id1}\t{a1}\n{id2}\t{a2}\n")
    if args.write_matrix:
        save_matrix_tsv(sim, os.path.join(pair_dir, f"{pair_name}.matrix.tsv"))
    if args.plot_matrix:
        save_matrix_png(
            sim,
            os.path.join(pair_dir, f"{pair_name}.matrix.png"),
            title=f"Cosine similarity: {id1} vs {id2}",
        )


def write_summary(path: str, rows: list[dict]) -> None:
    """The summary TSV as pandas writes it: floats by ``repr``, ints as
    ints, no index."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(SUMMARY_COLUMNS)
        for r in rows:
            w.writerow([repr(v) if isinstance(v, float) else v
                        for v in (r[c] for c in SUMMARY_COLUMNS)])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="All-vs-all alignment of node embeddings (affine-gap DP on the GPU)."
    )
    parser.add_argument("--input", required=True)
    parser.add_argument("--id-column", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--gap-open", type=float, default=-1.0)
    parser.add_argument("--gap-extend", type=float, default=-1.0)
    parser.add_argument("--gap", type=float, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--mode", choices=["global", "local"], default="global")
    parser.add_argument("--batch-size", type=int, default=64, help="Pairs per device batch.")
    parser.add_argument("--structure-column-name", default=None)
    parser.add_argument("--num-workers", type=int, default=1, help="Reference CLI compatibility.")
    parser.add_argument("--write-alignment", action="store_true")
    parser.add_argument("--write-matrix", action="store_true")
    parser.add_argument("--plot-matrix", action="store_true")
    parser.add_argument("--summary", default="summary.tsv")
    parser.add_argument(
        "--data-parallel",
        action="store_true",
        help="Spread pair batches over all visible devices (one card: no change).",
    )
    parser.add_argument("--device", default=None,
                        help="Device of the DP: the CUDA device when not given, "
                             "'cpu' only when asked.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--data-parallel over several cards is not ported yet (ROADMAP queue 1, item 11)"
        )

    os.makedirs(args.output_dir, exist_ok=True)
    table = read_table_auto(args.input)
    if args.id_column not in table.columns:
        raise ValueError(f"Required column '{args.id_column}' not found in input.")
    if "node_embeddings" not in table.columns:
        raise ValueError("Input does not contain a 'node_embeddings' column.")

    ids, mats, structs = [], [], []
    for row in table.rows:
        ids.append(row[args.id_column])
        mats.append(parse_matrix(row["node_embeddings"]))
        structs.append(
            str(row[args.structure_column_name]) if args.structure_column_name else None
        )

    n = len(ids)
    if n < 2:
        print("Nothing to do: fewer than 2 rows.")
        return

    if args.gap is not None:
        print("[align-batch] --gap is deprecated; treating as --gap-open.")
        args.gap_open = args.gap
    if args.gap_extend is None:
        args.gap_extend = args.gap_open

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    summary_rows = []
    for s in range(0, len(pairs), args.batch_size):
        chunk = pairs[s: s + args.batch_size]
        sims = [
            cosine_similarity_matrix(mats[i], mats[j]).astype(np.float32) for i, j in chunk
        ]
        results = affine_align_batch(sims, args.gap_open, args.gap_extend, args.mode,
                                     device=device)
        for (i, j), sim, (best_score, path) in zip(chunk, sims, results):
            _write_pair_outputs(args, ids[i], ids[j], structs[i], structs[j], sim, best_score, path)
            summary_rows.append(
                {
                    "id1": ids[i],
                    "id2": ids[j],
                    "n1": int(mats[i].shape[0]),
                    "n2": int(mats[j].shape[0]),
                    "score": float(best_score),
                    "mode": args.mode,
                    "gap_open": float(args.gap_open),
                    "gap_extend": float(args.gap_extend),
                }
            )

    out_path = os.path.join(args.output_dir, args.summary)
    write_summary(out_path, summary_rows)
    print(f"Processed {len(summary_rows)} pair(s). Summary written to {out_path}")


if __name__ == "__main__":
    main()
