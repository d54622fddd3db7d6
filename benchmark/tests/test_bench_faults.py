"""A run with the timed path broken underneath comes out not correct: for
each fault that the cell's driver can have (its ``FAULTS``, planted by
``benchmark/faults.py``), the harness (past its look for a card) drives
set-up, window and check at a tiny size on the CPU."""
import time

import pytest
import torch

from benchmark import faults as FL
from benchmark.harness import runner
from benchmark.tests import tiny


@pytest.mark.parametrize("cell,fault", tiny.FAULT_CASES)
def test_fault_is_caught(cell, fault):
    torch.set_num_threads(1)
    spec = tiny.spec(cell)
    with FL.planted(spec["traffic"]["driver"], fault):
        r = runner.run_spec(spec, 3_000_000_029, 0.1, False, tiny.CPU, time.perf_counter())
    assert not r["correct"], r["checks"]


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        with FL.planted("ppo_update", "no_such_fault"):
            pass
