"""``ginfinity-optimize-msa`` — hyperparameter search for the MSA engine.

Port of ``ginfinity_tpu/pipelines/optimize_msa.py``: the same flags
(plus ``--device``), objective and files.  The objective is the column
agreement of two named RNAs over their known homologous regions (+1 per
correctly co-aligned position, -1 otherwise), over alpha, beta,
gap_open, gap_extend and refine_iters.

Uses Optuna when it is installed (the same storage and study flags);
otherwise a seeded random search, which writes ``trials.csv`` (the bytes
``DataFrame.to_csv`` writes) and ``best_params.json``.  Each trial runs
the port's ``ginfinity-embed-msa`` in-process on ``--device``: the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import random
import shutil
import time
import uuid
from pathlib import Path

from ginfinity_tpu_torch.pipelines.msa_eval import load_aln_tsv
from ginfinity_tpu_torch.utils.device import resolve_device

PARAM_KEYS = ("refine_iters", "alpha", "beta", "gap_open", "gap_extend")


def parse_regions_tsv(path: Path) -> dict[str, tuple[int, int]]:
    regions: dict[str, tuple[int, int]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3 or parts[0] == "Name":
                continue
            try:
                regions[parts[0]] = (int(parts[1]), int(parts[2]))
            except ValueError:
                continue
    if not regions:
        raise ValueError(f"No regions parsed from {path}")
    return regions


def build_pos_to_col_map(aligned: str) -> dict[int, int]:
    pos_to_col = {}
    pos = 0
    for col, ch in enumerate(aligned):
        if ch != "-":
            pos += 1
            pos_to_col[pos] = col
    return pos_to_col


def compute_score(msa, regions, name1, name2) -> int:
    if name1 not in msa or name2 not in msa:
        raise ValueError(f"Required names not in MSA: {name1}, {name2}")
    a1, a2 = regions[name1]
    b1, b2 = regions[name2]
    if (a2 - a1) != (b2 - b1):
        raise ValueError("Region lengths differ between the two RNAs")
    s_map = build_pos_to_col_map(msa[name1])
    t_map = build_pos_to_col_map(msa[name2])
    score = 0
    for k in range(a2 - a1 + 1):
        c1 = s_map.get(a1 + k)
        c2 = t_map.get(b1 + k)
        score += 1 if (c1 is not None and c2 is not None and c1 == c2) else -1
    return score


def run_trial(args, outbase: Path, trial_id: str, params: dict) -> float:
    """One MSA run with ``params``; its score, or -1e9 when the run or
    the scoring failed (the error lands in the trial's ``error.txt``)."""
    from ginfinity_tpu_torch.pipelines.msa import main as msa_main

    tdir = outbase / args.study_name / f"trial_{trial_id}"
    tdir.mkdir(parents=True, exist_ok=True)
    out_prefix = tdir / "msa"
    argv = [
        "--input", args.input,
        "--name-col", args.name_col,
        "--embeds-col", args.embeds_col,
        "--topk", str(args.topk),
        "--consistency-rounds", str(args.consistency_rounds),
        "--tree", args.tree,
        "--max-pairs", str(args.max_pairs),
        "--seed", str(args.seed),
        "--out-prefix", str(out_prefix),
        "--refine-iters", str(params["refine_iters"]),
        "--alpha", str(params["alpha"]),
        "--beta", str(params["beta"]),
        "--gap-open", str(params["gap_open"]),
        "--gap-extend", str(params["gap_extend"]),
        "--device", str(args.device),
    ]
    if args.dotbracket_col:
        argv += ["--dotbracket-col", args.dotbracket_col]
    if args.paired_col:
        argv += ["--paired-col", args.paired_col]
    if args.plot_diagnostics:
        argv += ["--plot-diagnostics"]
    t0 = time.time()
    try:
        msa_main(argv)
        regions = parse_regions_tsv(Path(args.regions_tsv))
        msa = load_aln_tsv(str(out_prefix) + ".aln.tsv")
        score = float(compute_score(msa, regions, args.name_a, args.name_b))
    except Exception as exc:  # a failed trial scores -1e9; the search goes on
        (tdir / "error.txt").write_text(str(exc))
        score = -1e9
    (tdir / "trial_meta.json").write_text(json.dumps(
        {"params": params, "score": score, "elapsed_sec": round(time.time() - t0, 3)},
        indent=2))
    if not args.keep_outputs and score > -1e9:
        shutil.rmtree(tdir, ignore_errors=True)
    return score


def _sample_params(rng: random.Random) -> dict:
    return {
        "refine_iters": rng.choice([4, 16, 32, 64, 128]),
        "alpha": rng.uniform(1.0, 12.0),
        "beta": rng.uniform(-2.0, 1.0),
        "gap_open": rng.uniform(-5.0, -1.0),
        "gap_extend": rng.uniform(-5.0, -1.0),
    }


def _write_csv(path: Path, columns: list[str], rows: list[list]) -> None:
    """``DataFrame.to_csv(index=False)``'s bytes: floats as ``repr``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([repr(v) if isinstance(v, float) else v for v in r] for r in rows)


def build_parser():
    ap = argparse.ArgumentParser(
        description="Hyperparameter optimization for ginfinity-embed-msa (PyTorch port)")
    ap.add_argument("--input", required=True)
    ap.add_argument("--name-col", default="Name")
    ap.add_argument("--embeds-col", default="node_embeddings")
    ap.add_argument("--dotbracket-col", default="DotBracket")
    ap.add_argument("--paired-col", default=None)
    ap.add_argument("--topk", type=int, default=80)
    ap.add_argument("--consistency-rounds", type=int, default=30)
    ap.add_argument("--tree", choices=["nj", "upgma"], default="nj")
    ap.add_argument("--max-pairs", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--threads", type=int, default=1, help="Parallel trials (optuna only).")
    ap.add_argument("--n-trials", type=int, default=50)
    ap.add_argument("--storage", default="sqlite:///optuna_embed_msa.db")
    ap.add_argument("--study-name", default="embed_msa_opt")
    ap.add_argument("--regions-tsv", required=True, help="TSV with Name, Start, End")
    ap.add_argument("--outdir", default=str(Path.cwd() / "output" / "optuna_embed_msa"))
    ap.add_argument("--keep-outputs", dest="keep_outputs", action="store_true", default=True)
    ap.add_argument("--discard-outputs", dest="keep_outputs", action="store_false")
    ap.add_argument("--name-a", required=True)
    ap.add_argument("--name-b", required=True)
    ap.add_argument("--plot-diagnostics", action="store_true", default=True)
    ap.add_argument("--no-plot-diagnostics", dest="plot_diagnostics", action="store_false")
    ap.add_argument("--save-summary", action="store_true", default=True,
                    help="Write trials.csv and best_params.json to the study directory.")
    ap.add_argument("--no-save-summary", dest="save_summary", action="store_false")
    ap.add_argument("--device", default=None,
                    help="Device of every trial's MSA: the CUDA device when not "
                         "given, 'cpu' only when asked.")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)

    outbase = Path(args.outdir).resolve()
    outbase.mkdir(parents=True, exist_ok=True)
    study_dir = outbase / args.study_name
    study_dir.mkdir(parents=True, exist_ok=True)

    try:
        import optuna

        def objective(trial):
            params = {
                "refine_iters": trial.suggest_categorical("refine_iters", [4, 16, 32, 64, 128]),
                "alpha": trial.suggest_float("alpha", 1.0, 12.0),
                "beta": trial.suggest_float("beta", -2.0, 1.0),
                "gap_open": trial.suggest_float("gap_open", -5.0, -1.0),
                "gap_extend": trial.suggest_float("gap_extend", -5.0, -1.0),
            }
            return run_trial(args, outbase, f"{trial.number}_{uuid.uuid4().hex[:8]}", params)

        study = optuna.create_study(
            direction="maximize", study_name=args.study_name,
            storage=args.storage, load_if_exists=True,
        )
        study.optimize(objective, n_trials=args.n_trials, n_jobs=max(1, args.threads))
        best_params, best_value = study.best_trial.params, study.best_trial.value
        if args.save_summary:
            _write_csv(study_dir / "trials.csv", ["trial", *PARAM_KEYS, "value"],
                       [[t.number, *(t.params.get(k) for k in PARAM_KEYS), t.value]
                        for t in study.trials])
    except ImportError:
        print("[INFO] optuna not installed; using seeded random search fallback.")
        rng = random.Random(args.seed)
        results = []
        for t in range(args.n_trials):
            params = _sample_params(rng)
            score = run_trial(args, outbase, f"rs{t}", params)
            results.append({"trial": t, **params, "value": score})
            print(f"trial {t}: score={score} params={params}")
        if args.save_summary:
            columns = ["trial", *PARAM_KEYS, "value"]
            _write_csv(study_dir / "trials.csv", columns,
                       [[r[c] for c in columns] for r in results])
        best_row = max(results, key=lambda r: r["value"])  # the first of equal maxima
        best_value = float(best_row["value"])
        best_params = {k: (int(best_row[k]) if k == "refine_iters" else float(best_row[k]))
                       for k in PARAM_KEYS}

    print("Best value:", best_value)
    print("Best params:")
    print(json.dumps({k: (float(v) if not isinstance(v, (int, str)) else v)
                      for k, v in best_params.items()}, indent=2, default=float))
    if args.save_summary:
        (study_dir / "best_params.json").write_text(
            json.dumps(best_params, indent=2, default=float))


if __name__ == "__main__":
    main()
