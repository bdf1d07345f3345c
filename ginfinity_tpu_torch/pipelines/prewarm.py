"""``ginfinity-prewarm`` — the port's first-run step, ahead of time.

Port of ``ginfinity_tpu/pipelines/prewarm.py``, with the same flags (plus
``--device``).  The JAX package fills a persistent XLA compilation cache;
the port has no XLA and no such cache.  What a first run of the port
pays for instead is the build of its CUDA kernels: ``nvcc`` compiles
``ops/csrc/*.cu`` into one library under ``ginfinity_tpu_torch/_build/``,
which later processes load as long as the sources are unchanged.

- Window mode (``--input``, ``--model-path``, ``--window-size``, all
  required, as in the JAX CLI): builds the library and reports the
  corpus's capacity-ladder groups as the fused window path forms them
  (``fast_windows.py::_prep_corpus_groups``).  Nothing else is compiled:
  the port's window path has one kernel for every group.
- ``--msa N LMAX``: runs the port's ``ginfinity-embed-msa`` once on a
  seeded dummy family of that size for each ``--msa-dp-score`` mode, on
  ``--device`` (the card unless ``cpu``), outputs discarded.  The MSA
  launches no kernel of the port's own and caches nothing across
  processes; the run shows that the card takes a family of that size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import cell_text, read_table, write_tsv


def prewarm_windows(cfg, structures, L, keep_paired_neighbors=True, mask_threshold=0.0,
                    quiet=False, max_programs=None) -> dict:
    """Build the CUDA library and group the corpus as the window path
    does; returns the library's path, the seconds of its build (0 when it
    was built before) and each group's (capacity, structures, windows)."""
    from ginfinity_tpu_torch.ops import _build
    from ginfinity_tpu_torch.pipelines.fast_windows import _prep_corpus_groups

    t0 = time.perf_counter()
    built = _build.library_path().exists()
    lib = _build.build_library()
    build_s = 0.0 if built else time.perf_counter() - t0
    per, groups = _prep_corpus_groups(cfg, structures, L, keep_paired_neighbors,
                                      mask_threshold, max_programs)
    rows = [(n_cap, len(idxs), int(sum(per[i][4].size for i in idxs)))
            for n_cap, idxs in sorted(groups.items())]
    if not quiet:
        print(f"  library {lib} ({'built in %.1fs' % build_s if build_s else 'already built'})")
        for n_cap, n_struct, n_win in rows:
            print(f"  group n_cap={n_cap}: {n_struct} structure(s), {n_win} window(s)")
    return {"library": str(lib), "build_seconds": build_s, "groups": rows}


def prewarm_msa_bucket(n_seq, lmax, dim, max_pairs, topk, dp_score, refine_iters,
                       quiet=False, device=None):
    """Run the port's MSA pipeline on a seeded dummy family of ``n_seq``
    members of up to ``lmax`` positions (the JAX package's draws), outputs
    discarded."""
    from ginfinity_tpu_torch.pipelines.msa import main as msa_main

    rng = np.random.default_rng(0)
    base = rng.normal(size=(lmax, dim)).astype(np.float32)
    rows = []
    for s in range(n_seq):
        Ls = int(rng.integers(max(2, int(lmax * 0.85)), lmax + 1))
        emb = base[:Ls] + 0.1 * rng.normal(size=(Ls, dim)).astype(np.float32)
        rows.append([f"s{s}", json.dumps(emb.round(4).tolist())])
    with tempfile.TemporaryDirectory() as td:
        tsv = os.path.join(td, "family.tsv")
        write_tsv(tsv, ["Name", "node_embeddings"], rows)
        args = ["--input", tsv, "--out-prefix", os.path.join(td, "w", "msa"),
                "--alpha", "5", "--beta", "0", "--topk", str(topk),
                "--consistency-rounds", "1", "--max-pairs", str(max_pairs),
                "--dp-score", dp_score, "--refine-iters", str(refine_iters)]
        if device is not None:
            args += ["--device", str(device)]
        ctx = contextlib.redirect_stdout(sys.stderr) if quiet else contextlib.nullcontext()
        with ctx:
            msa_main(args)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The port's first-run step ahead of time (no XLA cache here): "
                    "build the CUDA kernels and group a corpus as the window path "
                    "does, or run the MSA engine once at a family scale (--msa N LMAX)."
    )
    ap.add_argument("--input", help="CSV/TSV with structures (window mode)")
    ap.add_argument("--structure-column-name", default="secondary_structure")
    ap.add_argument("--model-path")
    ap.add_argument("--window-size", type=int)
    ap.add_argument("--keep-paired-neighbors", action="store_true")
    ap.add_argument("--mask-threshold", type=float, default=0.0)
    ap.add_argument("--max-programs", type=int, default=None,
                    help="Match the --max-programs you will pass to ginfinity-embed "
                         "(the merged ladder groups the corpus differently).")
    ap.add_argument("--msa", nargs=2, type=int, metavar=("N", "LMAX"),
                    help="Run the MSA engine once on a seeded family of ~N members "
                         "with max length ~LMAX.")
    ap.add_argument("--msa-dim", type=int, default=128,
                    help="Node-embedding dimension (= the model's hidden size) for --msa.")
    ap.add_argument("--msa-max-pairs", type=int, default=2000,
                    help="Match the --max-pairs you will run with.")
    ap.add_argument("--msa-topk", type=int, default=20)
    ap.add_argument("--msa-dp-score", choices=["profile", "library", "both"], default="both")
    ap.add_argument("--msa-refine-iters", type=int, default=0,
                    help="Nonzero also runs the refinement.")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="Device of the --msa run: the CUDA device when not given, "
                         "'cpu' only when asked.")
    args = ap.parse_args(argv)

    if args.msa is None and not (args.input and args.model_path and args.window_size):
        raise SystemExit("Window mode needs --input, --model-path and "
                         "--window-size (or pass --msa N LMAX).")

    t0 = time.perf_counter()
    if args.msa is not None:
        device = resolve_device(args.device)
        n_seq, lmax = args.msa
        modes = ["profile", "library"] if args.msa_dp_score == "both" else [args.msa_dp_score]
        for mode in modes:
            if not args.quiet:
                print(f"[prewarm] MSA bucket N={n_seq} Lmax={lmax} dp-score={mode}...")
            prewarm_msa_bucket(n_seq, lmax, args.msa_dim, args.msa_max_pairs, args.msa_topk,
                               mode, args.msa_refine_iters, args.quiet, device)
        if not args.quiet:
            print(f"Prewarmed the MSA path in {time.perf_counter() - t0:.1f}s "
                  f"(no compilation cache: nothing persists for later processes).")
        return

    from ginfinity_tpu_torch.models.checkpoint import load_checkpoint

    sep = "\t" if args.input.endswith((".tsv", ".txt")) else ","
    table = read_table(args.input, sep=sep)
    if args.structure_column_name not in table.columns:
        raise SystemExit(f"Missing column {args.structure_column_name!r}")
    structures = [cell_text(s) for s in table.column(args.structure_column_name)]
    cfg = load_checkpoint(args.model_path)[0]
    res = prewarm_windows(cfg, structures, args.window_size, args.keep_paired_neighbors,
                          args.mask_threshold, args.quiet, args.max_programs)
    if not args.quiet:
        print(f"Prewarmed the CUDA library and {len(res['groups'])} window group(s) in "
              f"{time.perf_counter() - t0:.1f}s.")
    return res


if __name__ == "__main__":
    main()
