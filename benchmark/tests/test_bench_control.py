"""The control, the reference in the precision below the configuration's
put in the program's place, comes out not correct under each cell's
limits (at a tiny size on the CPU; on the card at the cells' sizes by
``benchmark/calibrate.py``)."""
import gc

import pytest
import torch

from benchmark.harness import manifest as M
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails(cell):
    torch.set_num_threads(1)
    spec = tiny.spec(cell)
    drv = M.driver(spec["traffic"]["driver"])
    run = drv.setup(spec, 4_000_000_003, tiny.CPU)
    drv.window(run, 0.1)
    drv.release(run)
    gc.collect()
    ref = drv.reference_record(run)
    sound = drv.numbers(run["record"], ref)
    control = drv.numbers(drv.reference_record(run, **drv.CONTROL), ref)
    limits = spec["limits"]
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits), control
