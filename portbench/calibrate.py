"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <name> --first-seed <n> --seeds 12 \
        [--control 3] [--fault altered --fault-seeds 3] --seconds 3

runs the cell (set-up, a short window at the cell's own load, the check)
on ``--seeds`` seeds in turn and prints each run's compared numbers;
then the control (the plain reference at TF32 in the program's place)
on ``--control`` seeds, and each ``--fault`` (``faults.py``) on
``--fault-seeds`` seeds.  The last line gives, per number, the largest
sound reading and the smallest control and fault readings.  It needs a
CUDA card, as ``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from portbench import faults, harness
    from portbench.run import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    plan = [("sound", None, False)] * args.seeds + [("control", None, True)] * args.control
    for f in args.fault:
        plan += [(f"fault:{f}", f, False)] * args.fault_seeds
    seed = args.first_seed
    by_run: dict = {}
    for what, fault, control in plan:
        cell = harness.load_cell(args.workload)
        if fault:
            faults.plant(cell.kind, cell.traffic["kind"], fault)
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, False, dev, t_start=t0, control=control)
        readings = {k: c["value"] for k, c in res["checked"].items()}
        by_run.setdefault(what, []).append(readings)
        print(json.dumps({"run": what, "seed": seed, "readings": readings,
                          "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                          "notes": res["_log"]["notes"],
                          "window": res["_log"]["window"],
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        seed += 1
    summary = {}
    for what, runs in by_run.items():
        pick = max if what == "sound" else min
        summary[what] = {k: pick(r[k] for r in runs) for k in runs[0]}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
