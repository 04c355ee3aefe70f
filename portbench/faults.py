"""Faults planted under a run's timed path, for the tests that show the
correctness check catches them (``tests/test_portbench_faults.py``) and
for reading them at the cell's size on the card (``calibrate.py``).
Each is a ``wrap`` for ``harness.run``: it takes the program's timed call
and returns a broken one."""
from __future__ import annotations

import torch


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def unchanged(step):
    """A train step that returns its parameters and state unchanged (it
    computes the step on copies)."""
    def broken(params, state, batch):
        _, _, metrics = step(_clone(params), _clone(state), batch)
        return params, state, metrics
    return broken


def half_batch(step):
    """A train step that leaves out half of the batch: the mean is taken
    over the rest."""
    def broken(params, state, batch):
        return step(params, state,
                    {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return broken


def altered_answer(prefill):
    """A prefill whose answer is altered where it is produced: the logits
    are moved one token along the vocabulary."""
    def broken(params, batch):
        return torch.roll(prefill(params, batch), 1, dims=-1)
    return broken


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
PREFILL = {"altered_answer": altered_answer}
