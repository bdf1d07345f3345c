"""The MSA consistency round's seconds on the card, on real slabs.

Runs ``ginfinity-embed-msa`` once on ``chip_smoke.py``'s ``msa_path``
family (200 records of 240-300 positions, 128-d, its flags: 2,000 kNN
pairs, top-k 20, one round), library mode, and keeps the slabs that the
posterior stage hands the consistency round (or loads them from
``--slabs`` when that file exists, and saves them there when it does
not).  Then it times ``_consistency_rounds_on_slabs`` on them ``--reps``
times under each ``GINFINITY_MSA_DENSE_BUDGET_MB`` of ``--budgets``
(``default`` leaves it unset), in turns: each run's seconds (the card
drained), peak memory above what was resident, and the SHA-256 of its
output slabs.  ``--tree`` imports the port and ``chip_smoke.py`` from
another checkout (an older commit unpacked beside this one), so two
commits can be timed on one card, on the same slabs, in one call.
Prints one JSON line.

    python3 msa_round_probe.py [--tree DIR] [--slabs PATH] [--reps 5]
        [--budgets default,0]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def parse() -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", help="checkout to import the port and chip_smoke.py from")
    p.add_argument("--slabs", help="file of captured slabs: loaded if present, else saved")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--budgets", default="default,0",
                   help="comma-separated budgets in MiB; 'default' leaves the variable unset")
    return p.parse_args()


def capture(cs, msa, dev) -> dict:
    """The consistency round's inputs in one CLI run on msa_path's family."""
    kept = {}
    real = msa._consistency_rounds_on_slabs

    def keep(kv, ki, pairs, N, rounds, lam, pmin, k, mesh=None):
        kept.update(kv=kv.cpu(), ki=ki.cpu(), pairs=[(int(a), int(b)) for a, b in pairs],
                    N=int(N), rounds=int(rounds), lam=float(lam), pmin=float(pmin), k=int(k))
        return real(kv, ki, pairs, N, rounds, lam, pmin, k, mesh)

    msa._consistency_rounds_on_slabs = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            src = cs.msa_family_tsv(os.path.join(tmp, "family.tsv"), cs.MSA_N, cs.MSA_LMAX)
            cs.msa_run(src, os.path.join(tmp, "lib", "msa"), [], str(dev))
    finally:
        msa._consistency_rounds_on_slabs = real
    return kept


def digest(out) -> str:
    h = hashlib.sha256()
    for x in out:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def timed(msa, s: dict, kv, ki, budget: str, dev) -> dict:
    os.environ.pop("GINFINITY_MSA_DENSE_BUDGET_MB", None)
    if budget != "default":
        os.environ["GINFINITY_MSA_DENSE_BUDGET_MB"] = budget
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = msa._consistency_rounds_on_slabs(kv, ki, s["pairs"], s["N"], s["rounds"], s["lam"],
                                           s["pmin"], s["k"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    rec = {"budget": budget, "seconds": sec,
           "peak_above_resident_bytes": torch.cuda.max_memory_allocated(dev) - resident,
           "sha256": digest(out)}
    rec.update(getattr(msa, "last_consistency_round", {}))
    return rec


def main() -> int:
    args = parse()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from ginfinity_tpu_torch.pipelines import msa

    if not torch.cuda.is_available():
        print("msa_round_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.slabs and os.path.exists(args.slabs):
        s = torch.load(args.slabs)
    else:
        s = capture(cs, msa, dev)
        if args.slabs:
            torch.save(s, args.slabs)
    kv, ki = s["kv"].to(dev), s["ki"].to(dev)
    budgets = args.budgets.split(",")
    timed(msa, s, kv, ki, budgets[0], dev)  # warm-up
    runs = [timed(msa, s, kv, ki, b, dev) for _ in range(args.reps) for b in budgets]
    by = {b: sorted(r["seconds"] for r in runs if r["budget"] == b) for b in budgets}
    print(json.dumps({
        "tree": args.tree or ".", "pairs": len(s["pairs"]), "records": s["N"],
        "width": int(kv.shape[1]), "k": s["k"], "rounds": s["rounds"],
        "median_seconds": {b: float(np.median(v)) for b, v in by.items()},
        "identical_across_budgets": len({r["sha256"] for r in runs}) == 1,
        "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
