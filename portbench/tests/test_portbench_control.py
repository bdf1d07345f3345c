"""On the card: the control, the plain reference computed at TF32 in the
program's place, comes out not correct in every cell, at sizes a test
run holds (the window and training cells' traffic cut as below; the
cells' own sizes are run by ``calibrate.py``).  Run on the card with
``python -m pytest portbench/tests -m card``."""

import pytest

from portbench import harness
from portbench.run import run_cell

SMALL = {
    "windows-long.forgi-4x512": {"pool": 32, "per_call": 8, "warmup_calls": 1},
    "train-align.forgi-4x512": {"families": 40, "batch_groups": 8},
    "align-allpairs.packaged-6x128": {},
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name, cuda_device):
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        cell = harness.load_cell(name)
        cell.traffic.update(SMALL[name])
        res = run_cell(cell, seed, 1.0, False, cuda_device, control=True)
        assert res["correct"] is False, res["checked"]
