"""Run one cell of the benchmark of ``ginfinity_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (imports, the CUDA context, the kernels' library, the
cell's inputs and weights made from the seed, warm-up) is timed as
``setup_s``; then a closed loop of the cell's requests runs for
``--seconds``.  ``--trace 1`` runs the same window and then profiles a
further ~2 s of requests, and reports the per-layer metrics instead of
the end-to-end ones.  After the window the program's outputs are held
to the plain reference (``correct``).

The process runs on a fixed pair of CPUs (the last two it may use), and
set-up's objects are frozen out of the garbage collector's scans before
the window.  Earlier lines of standard output give the card, its power
limit and those CPUs, the set-up split, the kernels' launch counters,
the window's calls (their quartiles of host seconds, the seconds the
collector took), numbers the check read beside those it compares, and
the card's clocks, power and throttle reasons just after the window;
the last line is the
result, one JSON object.  Standard error ends with each number compared
beside its limit.  Without a CUDA card, or with fewer cards than the cell
asks for, the run exits with code 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for BLAS and OpenMP: the card's host is shared, and a
# pool of threads on its cores makes the host-bound cells' runs spread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
PINNED_CPUS = 2
CARD_STATE = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ginfinity_tpu")
TRACE_SECONDS = 2.0
EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def nvidia_smi(fields: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"
    return out.strip().replace("\n", "; ")


def card_line() -> str:
    return "card: " + nvidia_smi("name,power.limit")


def launch_counters() -> dict:
    from ginfinity_tpu_torch.ops.dp_wavefront import dp_wavefront
    from ginfinity_tpu_torch.ops.windows_encoder import forward_windows

    return {"forward_windows.launches": forward_windows.launches,
            "dp_wavefront.launches": dp_wavefront.launches,
            "dp_wavefront.warp_launches": dp_wavefront.warp_launches}


def pin_cpus(n: int = PINNED_CPUS) -> list:
    """Bind this process, and every thread it starts later, to the last
    ``n`` CPUs it may run on: a fixed set, so that the host-bound loops
    do not migrate between cores from run to run."""
    cpus = sorted(os.sched_getaffinity(0))[-n:]
    os.sched_setaffinity(0, cpus)
    return cpus


def _loop(cell, state, env, seconds: float, calls: list, durations: list) -> float:
    """Requests until ``seconds`` have passed (at least one); the elapsed
    seconds, synchronised.  ``durations`` gets each call's host seconds."""
    from portbench.harness import sync

    sync(env.device)
    t0 = t = time.perf_counter()
    while True:
        calls.append(cell.kind.call(state, env))
        durations.append(time.perf_counter() - t)
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
    sync(env.device)
    return time.perf_counter() - t0


class GcClock:
    """Seconds spent in Python's garbage collector while it is on."""

    def __init__(self):
        self.seconds, self._t = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _quartiles(values: list) -> list:
    if len(values) < 2:
        return list(values)
    return [min(values), *statistics.quantiles(values, n=4), max(values)]


def _sum_counts(calls) -> dict:
    out: dict = {}
    for w in calls:
        for k, v in w.counts.items():
            out[k] = out.get(k, 0) + v
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start=None,
             control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, traced segment,
    check.  Returns the result object (``correct`` ... ``checked``) and,
    under ``"_log"``, what the earlier lines print."""
    import torch

    from portbench import harness

    t_start = T_START if t_start is None else t_start
    env = harness.Env(cell, seed, device, trace)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    state = cell.kind.setup(env)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start

    window_calls, durations = [], []
    env.spans.clear()
    env.events.clear()
    # set-up's objects leave the collector's scans; the program's own
    # garbage is still collected in the window
    gc.collect()
    gc.freeze()
    with GcClock() as gc_clock:
        window_s = _loop(cell, state, env, seconds, window_calls, durations)
    # the card's clocks under the window's load: a card held below its
    # clocks (power, heat) reads slower in every cell
    card_after = nvidia_smi(CARD_STATE) if device.type == "cuda" else None
    units = sum(w.units for w in window_calls)
    e2e = cell.kind.end_to_end(units, window_s)

    summary, traced_calls = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            harness.sync(device)
            env.profiling = True
            w0 = time.time_ns()
            _loop(cell, state, env, min(TRACE_SECONDS, seconds), traced_calls, [])
            w1 = time.time_ns()
            env.profiling = False
        summary = harness.summarise_trace(
            harness.device_events(prof) if device.type == "cuda" else [], env.marks, w0, w1)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    launches = launch_counters()

    readings = cell.kind.check(state, env, control=control)
    checked = {k: {"value": float(v), "limit": float(cell.limits[k])}
               for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checked.values()) and \
        set(readings) == set(cell.limits)

    if trace:
        r = harness.Reading(window_s, _sum_counts(window_calls), _sum_counts(traced_calls),
                            dict(env.spans),
                            {k: [a.elapsed_time(b) for a, b in v] for k, v in env.events.items()},
                            summary, harness.peaks())
        metrics = {}
        for m in cell.per_layer:
            v = m["reader"].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev_block = {"platform": "gpu" if device.type == "cuda" else device.type,
                 "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                 "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev_block.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": bool(correct), "attempted": units + sum(w.units for w in traced_calls),
              "failed": 0, "metrics": metrics, "device": dev_block}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checked"] = checked
    result["_log"] = {"setup_split": dict(env.split, total=setup_s), "launches": launches,
                      "window": {"seconds": window_s, "units": units,
                                 "requests": len(window_calls), "gc_s": gc_clock.seconds,
                                 "call_s_quartiles": _quartiles(durations)},
                      "notes": env.notes, "card_after_window": card_after}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    cpus = pin_cpus()
    import torch

    split = {"torch_import": time.perf_counter() - T_START}
    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"{n} visible. Nothing was measured.", file=sys.stderr)
        return EXIT_NO_CARD
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    split["cuda_context"] = time.perf_counter() - t
    print(card_line() + f"; cpus {cpus}", flush=True)

    from ginfinity_tpu_torch.graphs.dotbracket import pair_table
    from ginfinity_tpu_torch.ops._build import build_library, library_path

    t = time.perf_counter()
    built = not library_path().exists()
    build_library()
    pair_table("((...))")  # the native host parser, built at first use
    split["library_build" if built else "library_load"] = time.perf_counter() - t

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    log = result.pop("_log")
    log["setup_split"] = {**split, **log["setup_split"]}
    print(json.dumps({"setup_split": log["setup_split"]}), flush=True)
    print(json.dumps({"launches": log["launches"], "window": log["window"],
                      "notes": log["notes"]}), flush=True)
    print(f"card after window ({CARD_STATE}): {log['card_after_window']}", flush=True)

    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for k, c in result["checked"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
