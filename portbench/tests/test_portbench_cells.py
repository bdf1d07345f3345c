"""Each cell runs end to end on the CPU at a tiny size (the program's
plain kernels, the reference beside them), comes out ``correct``, and
prints the contract's keys; with a fault planted under its timed path
(``faults.py``) it comes out not correct.  The look for a card is
skipped: ``run_cell`` is handed the CPU."""

import json

import pytest
import torch

from portbench import faults, harness
from portbench.run import run_cell

TINY = {
    "windows-long.forgi-4x512": {"pool": 4, "length_min": 130, "length_max": 220,
                                    "per_call": 2, "warmup_calls": 1, "check_transcripts": 2,
                                    "check_windows_each": 8},
    "train-align.forgi-4x512": {"families": 6, "members": 3, "ancestor_min": 40,
                                "ancestor_max": 60, "batch_groups": 2},
    "align-allpairs.packaged-6x128": {"families": 3, "members": 3, "ancestor_min": 40,
                                      "ancestor_max": 80, "batch_pairs": 8, "check_pairs": 36},
}
# a negative sample and unaligned picks small enough that the tiny
# families draw them from the run's generator
TINY_CONFIG = {"train-align.forgi-4x512": {"alignment_max_negatives": 8,
                                           "alignment_unaligned_per_graph": 1}}
SEED = 2**31 + 977  # more than 32 signed bits hold


def tiny_cell(name):
    cell = harness.load_cell(name)
    cell.traffic.update(TINY[name])
    cell.config.update(TINY_CONFIG.get(name, {}))
    return cell


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_is_correct_with_the_contract_keys(name, trace):
    cell = tiny_cell(name)
    res = run_cell(cell, SEED, 0.3, bool(trace), torch.device("cpu"))
    log = res.pop("_log")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checked"]
    assert res["correct"] is True, res["checked"]
    assert set(res["checked"]) == set(cell.limits)
    assert res["attempted"] > 0 and res["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert log["window"]["requests"] >= 1
    json.dumps(res)


def test_same_seed_same_inputs():
    a, b = (tiny_cell("align-allpairs.packaged-6x128") for _ in range(2))
    sa = a.kind.setup(harness.Env(a, SEED, torch.device("cpu"), False))
    sb = b.kind.setup(harness.Env(b, SEED, torch.device("cpu"), False))
    assert sa.structures == sb.structures
    assert all((x == y).all() for x, y in zip(sa.mats, sb.mats))


@pytest.mark.parametrize("name, fault", [(n, f) for n in sorted(TINY)
                                         for f in faults.FAULTS[harness.load_cell(n)
                                                                .traffic["kind"]]])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    faults.plant(cell.kind, cell.traffic["kind"], fault)
    res = run_cell(cell, SEED, 0.3, False, torch.device("cpu"))
    assert res["correct"] is False, res["checked"]
