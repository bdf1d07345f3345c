"""``BENCHMARK.json`` keeps to its contract, and every cell, traffic,
configuration, limit and per-layer metric resolves to its files by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    for fn in ("setup", "call", "check", "end_to_end"):
        assert callable(getattr(cell.kind, fn))
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(callable(m["reader"].read) for m in cell.per_layer)
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    assert set(cell.kind.end_to_end(10, 2.0)) == set(e2e) - {"setup_s"}


def test_names_units_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {"setup_s"} < {m["name"] for m in BENCH["end_to_end"]}


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        cells = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(cells), m["name"]
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert c["file"].startswith("portbench/") and path.is_file()
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
