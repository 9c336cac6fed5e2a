"""Each cell's control, on the card at the cell's own size: the cell
computed one precision below the one its configuration states has to come
out not correct on three seeds (`portbench/control.py`)."""

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda_device):
    harness.set_cache_dirs()
    for seed in (101, 102, 103):
        out = control.readings(cell, seed, cuda_device)
        assert not out["correct"], out["readings"]
