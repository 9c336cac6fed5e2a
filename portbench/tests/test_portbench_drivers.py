"""Each cell driven on the CPU at a tiny size through the kernels' plain
versions (the harness's look for a card skipped): a sound run comes out
correct, and a run with the timed path broken underneath comes out not
correct, once for each fault the cell can have.  One chip only, so no
cell has an exchange between chips to leave out."""

import time

import pytest
import torch

from portbench import faults, harness

TINY = {
    "ar.fit-p4-4096": {"rows": [96, 48, 16], "n_test": 16, "steps": 12},
    "ar.query-4096": {"rows": [96, 48, 16], "steps": 12, "sizes": [1, 5, 40], "pool": 50, "warm": 4,
                      "checked": 8},
}


def _run(cell, seed=12345678901):
    return harness.execute(cell, seed, 0.5, False, time.time(), torch.device("cpu"), TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out["checks"]) and all(set(c) == {"value", "limit"} for c in out["checks"].values())


CELLS_OF = {
    "frozen_steps": ["ar.fit-p4-4096"],
    "half_rows": ["ar.fit-p4-4096"],
    "half_queries": ["ar.query-4096"],
    "altered_answer": sorted(TINY),
}
CASES = [(f, c) for f, cells in CELLS_OF.items() for c in cells]


@pytest.mark.parametrize("fault,cell", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_fault_is_not_correct(fault, cell):
    with faults.FAULTS[fault]():
        out = _run(cell)
    assert not out["correct"], out["checks"]
