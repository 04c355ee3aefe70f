"""The control, the reference computed with fp8 weight products put in the
program's place, comes out not correct under each cell's limits (at a
smoke size on the CPU; on the card at the cell's size, ``calibrate.py``)."""
import time

import pytest
import torch

from portbench import harness
from portbench.tests.smoke import smoke_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["zamba2-train", "rwkv6-train",
                                  "zamba2-prefill"])
def test_the_control_is_not_correct(name):
    cell = smoke_cell(name)
    failed = []
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        notes = {"control": True}
        harness.run(cell, seed, 0.3, False, CPU, time.perf_counter(),
                    notes=notes)
        ctl = notes["control"]
        failed.append(any(ctl[k] > cell.limits[k] for k in ctl
                          if k in cell.limits))
    assert all(failed)
