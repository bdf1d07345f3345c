"""The benchmark's machinery, shared by every cell.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything
that belongs to it is found by name:

- its configuration: the ``file`` of its ``configs`` entry;
- its traffic: ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the code that makes and sends its requests,
  ``portbench/kinds/<kind>.py``;
- its limits: ``portbench/limits/<workload>.json``, each number that
  decides ``correct`` with its limit;
- its per-layer metrics: ``portbench/metrics/<metric>.py`` for every
  ``per_layer`` entry that lists the cell (or lists no cells).

A kind module defines ``setup(env) -> state``, ``call(state, env) ->
Work`` (one request of the closed loop, its results kept in ``state``)
and ``check(state, env, control=False) -> {number: value}`` (after the
window: the program's outputs against the plain reference under
``portbench/reference/``; with ``control`` the reference computed at
TF32 stands in the program's place).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Work:
    """One request's units of work (windows, graphs, pairs) and the counts
    the per-layer metrics read (FLOPs, bytes), by name."""

    units: int
    counts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: object
    limits: dict
    end_to_end: list
    per_layer: list


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lists(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json`` with its
    files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((PACKAGE / "traffic" / f"{entry['traffic']}.json").read_text())
    kind = _module(PACKAGE / "kinds" / f"{traffic['kind']}.py", f"portbench_kind_{traffic['kind']}")
    limits = json.loads((PACKAGE / "limits" / f"{name}.json").read_text())["limits"]
    e2e = [m for m in bench["end_to_end"] if _lists(m, name)]
    layers = [dict(m, reader=_module(PACKAGE / "metrics" / f"{m['name']}.py",
                                     "portbench_metric_" + m["name"].replace(".", "_")))
              for m in bench["per_layer"] if _lists(m, name)]
    return Cell(name, entry["chips"], config, traffic, kind, limits, e2e, layers)


class Env:
    """What a kind sees of a run: the device, the seed, the cell's data,
    the set-up split and the marks of the traced segment."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, trace: bool):
        self.seed, self.device, self.trace = seed, device, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.split: dict = {}
        self.marks: list = []       # (name, wall start ns, wall end ns) while profiling
        self.notes: dict = {}       # numbers the check reads but does not compare
        self.profiling = False

    @contextlib.contextmanager
    def stage(self, name: str):
        """A part of set-up, on the host clock (synchronised)."""
        sync(self.device)
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.split[name] = self.split.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, name: str):
        """A call into the program, marked on the wall clock while the
        profiler runs: it labels the idle gaps that no program span
        holds."""
        w0 = time.time_ns() if self.profiling else None
        yield
        if w0 is not None:
            self.marks.append((name, w0, time.time_ns()))


class Sample:
    """What a check reads of the window's answers, kept as they finish: a
    reservoir of ``k`` finished items drawn from ``seed`` (each finished
    item equally likely to stay), and the largest finished item by its
    ``size``.  Only what stays is kept (``keep(value)`` makes the copy
    that stays), so the window's answers are not held in memory."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.items: list = []       # (key, value)
        self.seen = 0
        self.largest = None         # (size, key, value)

    def offer(self, key, size, value, keep=lambda v: v) -> None:
        n, self.seen = self.seen, self.seen + 1
        slot = n if n < self.k else int(self.rng.integers(0, n + 1))
        stays = slot < self.k
        if stays or self.largest is None or size > self.largest[0]:
            value = keep(value)
        if stays:
            if n < self.k:
                self.items.append((key, value))
            else:
                self.items[slot] = (key, value)
        if self.largest is None or size > self.largest[0]:
            self.largest = (size, key, value)

    def picks(self) -> list:
        """``(key, value)`` of the largest finished item, then of the
        reservoir's others, ``k`` in all."""
        if self.largest is None:
            return []
        _, key, value = self.largest
        return ([(key, value)] + [kv for kv in self.items if kv[0] != key])[:self.k]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def summarise_trace(events, marks, t0_ns: int, t1_ns: int, program_spans=()) -> dict:
    """Device time by operation, the union of device activity and the
    longest idle gaps inside ``[t0_ns, t1_ns]``.  ``events``: ``(name,
    start ns, duration ns)`` of every device-side activity in the profile.
    A gap is labelled by the innermost program span (the latest to start,
    of ``program_spans``, the program's records on the same wall clock)
    that holds its midpoint, else by the harness's mark (``marks``) that
    holds it, else ``"between calls"``."""
    spans = sorted((max(s, t0_ns), min(s + d, t1_ns), n) for n, s, d in events
                   if s + d > t0_ns and s < t1_ns)
    by_name: dict = {}
    busy, end, gaps = 0, t0_ns, []
    for a, b, n in spans:
        by_name[n] = by_name.get(n, 0) + (b - a)
        if a > end:
            gaps.append((end, a))
        busy += max(0, b - max(a, end))
        end = max(end, b)
    if end < t1_ns:
        gaps.append((end, t1_ns))

    def label(a, b):
        mid = (a + b) // 2
        held = [(r.start_ns, r.name) for r in program_spans if r.start_ns <= mid <= r.end_ns]
        if held:
            return max(held)[1]
        marked = [n for n, s, e in marks if s <= mid <= e]
        return marked[-1] if marked else "between calls"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": {n: v / 1e9 for n, v in by_name.items()},
        "device_ops": [[n[:120], v / 1e9] for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in gaps[:10]],
    }


def device_events(prof) -> list:
    """``(name, start ns, duration ns)`` of the profile's device-side
    activities (kernels, copies, sets)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            out.append((e.name(), e.start_ns(), e.duration_ns()))
    return out


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets: the window's counts and
    length, the traced segment's counts and trace, and the peak table.
    The program's spans it reads through ``portbench/spans.py``."""

    window_s: float
    counts: dict
    traced_counts: dict
    trace: dict | None
    peaks: dict


def peaks() -> dict:
    return json.loads((PACKAGE / "peaks.json").read_text())
