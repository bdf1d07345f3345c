"""``ginfinity-embed`` — graph embeddings from dot-bracket structures.

Port of ``ginfinity_tpu/pipelines/embed.py``: the same flags and
defaults, the same TSV schema (``embedding_vector`` as comma-joined
``%.6f`` strings, window columns first).  Three modes run on the GPU,
or on the CPU with ``--device cpu``: whole-structure graph embeddings
(the default), the fused sliding-window mode (``--window-size``), and
precomputed window graphs (``--graph-pt`` with ``--meta-tsv``, the
output of ``python -m ginfinity_tpu_torch.pipelines.windows``).  Each
mode takes ``--precision bf16``, the speed mode (products of bf16
operands summed in float32); ``--bf16-check N`` measures its agreement
with f32 on a sample of the window mode's corpus, and ``--profile-dir``
writes a ``torch.profiler`` trace of the run.  ``--data-parallel``
shards the graph batches or the windows over every visible card
(``parallel/mesh.py``); with one card visible it runs unsharded.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.parallel.mesh import data_parallel_mesh
from ginfinity_tpu_torch.utils import trace
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
    precision: str = "highest",
    device=None,
    mesh=None,
):
    """One graph embedding per valid structure: the id column, then
    ``window_start``/``window_end`` when present, ``embedding_vector``,
    and the other kept columns sorted.  With no valid structure the TSV
    holds the header alone.  ``mesh`` shards the batches."""
    from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures

    final_keep = [id_column]
    if "seq_len" in input_table.columns:
        final_keep.append("seq_len")
    if keep_cols:
        final_keep.extend(keep_cols)

    engine = InferenceEngine.from_checkpoint(model_path, precision=precision, device=device,
                                             max_nodes_per_batch=batch_nodes, mesh=mesh)
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
    precision: str = "highest",
    max_programs: int | None = None,
    bf16_check: int = 0,
    wire: str | None = None,
    device=None,
    mesh=None,
):
    """Fused sliding-window embedding (--window-size): every window of
    every structure is built and embedded on the device in one pass
    (``mesh``: the windows shard over its devices).
    One row per window: window_id, the id column, window_start,
    window_end, seq_len, embedding_vector, then the kept columns."""
    from ginfinity_tpu_torch.models.checkpoint import load_checkpoint
    from ginfinity_tpu_torch.models.gine import GINModel
    from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows

    dev = resolve_device(device)
    with trace.span("embed.load"):
        cfg, params, state, _ = load_checkpoint(model_path)
        if precision != "highest":
            cfg = cfg.with_precision(precision)
            if not quiet:
                print("[generate_window_embeddings] bf16 speed mode: per-window "
                      "agreement with f32 has a tail; --bf16-check N measures it on "
                      "this corpus. Use the default f32 when exact retrieval parity "
                      "matters.")
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
        max_programs=max_programs, mesh=mesh, wire=wire, device=dev,
    )
    if precision != "highest" and bf16_check > 0:
        _report_bf16_tail(cfg, params, state, structures, ids, results, window_size,
                          keep_paired_neighbors, mask_threshold, bf16_check, log_path,
                          quiet, wire=wire, device=dev)
    with trace.span("embed.write"):
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


def _report_bf16_tail(cfg, params, state, structures, ids, results, window_size,
                      keep_paired_neighbors, mask_threshold, n_sample, log_path, quiet,
                      wire=None, device=None):
    """``--bf16-check N``: re-embed a fixed sample of about ``N`` windows
    (whole structures, in the order of ``default_rng(0).permutation``) at
    f32 and log each window's cosine against its bf16 embedding: mean,
    min and the worst windows.  With ``wire='f16'`` the delivered rows
    also carry the wire's rounding, so the sample is first re-embedded at
    the production precision with the exact f32 wire, and the comparison
    is of bf16 compute alone."""
    from ginfinity_tpu_torch.models.gine import GINModel
    from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows

    rng = np.random.default_rng(0)
    order = rng.permutation(len(structures))
    take, n_win = [], 0
    for i in order:
        if len(results[i][0]) == 0:
            continue
        take.append(int(i))
        n_win += len(results[i][0])
        if n_win >= n_sample:
            break
    if not take:
        return
    sample = [structures[i] for i in take]
    if wire == "f16":
        prod = embed_corpus_windows(GINModel(cfg, params, state), sample, window_size,
                                    keep_paired_neighbors, mask_threshold, device=device)
        results = dict(zip(take, prod))
    f32_res = embed_corpus_windows(GINModel(cfg.with_precision("highest"), params, state),
                                   sample, window_size, keep_paired_neighbors,
                                   mask_threshold, device=device)
    cos, names = [], []
    for i, (_, f32_emb) in zip(take, f32_res):
        starts, bf16_emb = results[i]
        a = np.asarray(bf16_emb, np.float32)
        b = np.asarray(f32_emb, np.float32)
        num = np.sum(a * b, axis=1)
        den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        cos.append(num / np.maximum(den, 1e-12))
        names.extend(f"{ids[i]}_{int(s)}" for s in starts)
    cos = np.concatenate(cos)
    worst = np.argsort(cos)[: min(5, len(cos))]
    diag = {
        "bf16_check_windows": int(len(cos)),
        "bf16_cosine_vs_f32_mean": round(float(cos.mean()), 6),
        "bf16_cosine_vs_f32_min": round(float(cos.min()), 6),
        "bf16_worst_windows": {names[int(j)]: round(float(cos[j]), 6) for j in worst},
    }
    if wire == "f16":
        diag["wire_note"] = ("delivered rows additionally carry --wire f16 "
                             "rounding (<=2^-11 rel/element), excluded from "
                             "this comparison")
    log_information(log_path, diag, "bf16_check")
    if not quiet:
        print(f"[bf16-check] {len(cos)} windows re-embedded at f32: "
              f"cosine mean {diag['bf16_cosine_vs_f32_mean']}, "
              f"min {diag['bf16_cosine_vs_f32_min']}"
              + ("" if cos.min() >= 0.99 else
                 f" — WORST: {diag['bf16_worst_windows']}"))


def _embed_precomputed(args, device, mesh=None):
    """``--graph-pt`` mode: one embedding per window graph, in the order of
    the metadata TSV, written beside each row's metadata; ``mesh`` shards
    the batches."""
    from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, adapt_graphs_to_model
    from ginfinity_tpu_torch.pipelines.windows import load_precomputed, write_precomputed

    meta, graphs = load_precomputed(args.graph_pt, args.meta_tsv)
    log_path = os.path.splitext(args.output)[0] + ".log"
    open(log_path, "a").close()
    engine = InferenceEngine.from_checkpoint(args.model_path, precision=_precision(args),
                                             device=device, max_nodes_per_batch=args.batch_nodes,
                                             mesh=mesh)
    embeddings = engine.embed_graphs(adapt_graphs_to_model(graphs, engine.config))
    write_precomputed(args.output, meta, args.id_column, "embedding_vector",
                      [format_embedding(v) for v in embeddings])
    log_information(log_path, {"num_embeddings": len(meta.rows)}, "generate_embeddings")
    print(f"Embeddings saved to {args.output}")


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
                        help="Write a torch.profiler trace of the run to this directory "
                             "(Chrome trace JSON; view with TensorBoard or Perfetto).")
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
                             "<=4.9e-4 relative rounding. Default: f32, except "
                             "under --precision bf16, where f16 is used (its "
                             "rounding is 8x below bf16's own step); pass "
                             "--wire f32 to force the exact download.")
    parser.add_argument("--bf16-check", type=int, default=0, metavar="N",
                        help="With --precision bf16 and --window-size: "
                             "re-embed ~N sampled windows at f32 and log the "
                             "cosine agreement. 0 (default) disables.")
    return parser


def _precision(args) -> str:
    """The config's ``matmul_precision`` for ``--precision``."""
    return "highest" if args.precision == "f32" else "bf16"


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.profile_dir:
        return _profiled(args)
    return _main_inner(args)


def _profiled(args):
    """The run inside ``torch.profiler.profile``: host activity, and the
    card's when the run is on one; the trace is written into
    ``--profile-dir`` as ``<host>_<pid>.<ms>.pt.trace.json`` when the run
    ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(args.device or "cuda").type == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(args.profile_dir)):
        return _main_inner(args)


def _main_inner(args):
    if args.wire == "f16" and args.window_size is None:
        sys.exit("ERROR: --wire f16 requires --window-size (it is the encoding "
                 "of the fused window-embedding download).")
    if args.wire is None:
        # bf16 compute takes the f16 wire (its rounding is 8x below bf16's
        # own step); an explicit --wire wins
        args.wire = ("f16" if args.precision == "bf16"
                     and args.window_size is not None else "f32")
        if args.wire == "f16" and not args.quiet:
            print("[generate_embeddings] --precision bf16: using the f16 "
                  "result wire (halved download; pass --wire f32 to force "
                  "the exact download)")
    device = resolve_device(args.device)
    if args.model_path is None:
        sys.exit("ERROR: no --model-path given. Pass --model-path "
                 "(a reference .pth works directly).")
    if bool(args.graph_pt) != bool(args.meta_tsv):
        sys.exit("ERROR: --graph-pt and --meta-tsv must be given together.")
    mesh = None
    if args.data_parallel:
        mesh = data_parallel_mesh(device)
        if mesh is not None:
            if not args.quiet:
                print(f"[generate_embeddings] data parallel over {mesh.size} devices")
        elif not args.quiet:
            print("[generate_embeddings] --data-parallel: single device "
                  "visible; running unsharded")
    if args.graph_pt:
        _embed_precomputed(args, device, mesh)
        return

    with trace.span("embed.read"):
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
            precision=_precision(args),
            device=device,
            mesh=mesh,
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
        precision=_precision(args),
        max_programs=args.max_programs,
        bf16_check=args.bf16_check,
        wire=None if args.wire == "f32" else args.wire,
        device=device,
        mesh=mesh,
    )


if __name__ == "__main__":
    main()
