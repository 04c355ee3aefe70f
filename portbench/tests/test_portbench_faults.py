"""A run with its timed path broken underneath must come out not correct
under the cell's own limits: the harness's look for a card is skipped and
the rest of a run (set-up, a short window, the comparison) is driven at a
smoke size on the CPU, once for each fault the cell can have.  One chip,
so no exchange between chips to leave out."""
import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests.smoke import smoke_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def run(cell, wrap=None):
    return harness.run(cell, SEED, 0.5, False, CPU, time.perf_counter(),
                       wrap=wrap)


def over(out):
    return sorted(k for k, v in out["checks"].items()
                  if v["value"] > v["limit"])


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("name", ["zamba2-train", "rwkv6-train"])
def test_a_broken_train_step_is_not_correct(name, fault):
    out = run(smoke_cell(name, batch=4), faults.TRAIN[fault])
    assert out["correct"] is False, out["checks"]


def test_an_altered_answer_is_not_correct():
    out = run(smoke_cell("zamba2-prefill"), faults.altered_answer)
    assert out["correct"] is False, out["checks"]
