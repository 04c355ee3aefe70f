"""The port's pipeline schedules against the reference's, slot by slot.

For every ``(S, M)`` of the reference's grid (``tests/test_pipeline_schedule.py``)
GPipe, 1F1B and interleaved 1F1B come out of ``repro_torch.core.pipeline_schedule``
with the same reservation table as ``repro.core.pipeline_schedule``, the same
analytics (bubble fractions, peak activations, steady II) and a clean
``verify()``.  The numerical equivalence runs in torch: a toy 4-stage model
executed under the port's 1F1B table equals its sequential execution and the
reference's numpy run of the same weights.
"""
import numpy as np
import pytest
import torch

from repro.core import pipeline_schedule as ref
from repro_torch.core import pipeline_schedule as port

GRID = [(2, 4), (4, 8), (4, 16), (8, 16)]
BUILDERS = {"gpipe": lambda m, S, M: m.gpipe(S, M),
            "1f1b": lambda m, S, M: m.one_f_one_b(S, M),
            "interleaved": lambda m, S, M: m.interleaved_1f1b(S, M, 2)}


@pytest.mark.parametrize("S,M", GRID)
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_schedules_match_slot_by_slot(kind, S, M):
    got, want = BUILDERS[kind](port, S, M), BUILDERS[kind](ref, S, M)
    got.verify()
    assert (got.name, got.n_stages, got.n_microbatches, got.n_chunks) == \
        (want.name, want.n_stages, want.n_microbatches, want.n_chunks)
    assert got.table == want.table
    assert got.total_ticks == want.total_ticks
    assert got.steady_ii == want.steady_ii
    assert got.bubble_fraction() == want.bubble_fraction()
    assert got.weighted_bubble_fraction() == want.weighted_bubble_fraction()
    assert got.peak_in_flight() == want.peak_in_flight()


@pytest.mark.parametrize("S,M", GRID)
def test_bubble_model_matches(S, M):
    for chunks in (1, 2, 4):
        assert port.bubble_model(S, M, chunks) == ref.bubble_model(S, M,
                                                                   chunks)
    assert abs(port.gpipe(S, M).bubble_fraction()
               - port.bubble_model(S, M)) < 1e-9


def test_verify_catches_a_broken_table():
    sched = port.one_f_one_b(4, 8)
    # swap the first stage-1 forward with an idle tick: its input is not
    # ready yet
    t = next(t for t, row in enumerate(sched.table) if row[1] is not None)
    sched.table[0][1], sched.table[t][1] = sched.table[t][1], None
    with pytest.raises(AssertionError):
        sched.verify()


def test_schedule_numerical_equivalence_in_torch():
    """A toy 4-stage tanh model run under the port's 1F1B table equals its
    sequential run in torch and the reference's numpy oracle."""
    S, M = 4, 6
    rng = np.random.default_rng(0)
    ws_np = [rng.normal(size=(8, 8)) * 0.3 for _ in range(S)]
    xs_np = [rng.normal(size=(8,)) for _ in range(M)]
    Ws = [torch.from_numpy(w) for w in ws_np]
    xs = [torch.from_numpy(x) for x in xs_np]

    def fwd_stage(s, h):
        return torch.tanh(Ws[s] @ h)

    seq_out, seq_grad = [], []
    for m in range(M):
        acts = [xs[m]]
        for s in range(S):
            acts.append(fwd_stage(s, acts[-1]))
        seq_out.append(acts[-1])
        g = torch.ones(8, dtype=torch.float64)
        for s in reversed(range(S)):
            g = Ws[s].T @ (g * (1 - acts[s + 1] ** 2))
        seq_grad.append(g)
    # the reference's numpy oracle on the same weights
    np_out = []
    for m in range(M):
        h = xs_np[m]
        for s in range(S):
            h = np.tanh(ws_np[s] @ h)
        np_out.append(h)

    sched = port.one_f_one_b(S, M)
    sched.verify()
    assert sched.table == ref.one_f_one_b(S, M).table
    acts, grads = {}, {}
    for row in sched.table:
        updates = []
        for s, slot in enumerate(row):
            if slot is None:
                continue
            phase, m, _ = slot
            if phase == port.FWD:
                h_in = xs[m] if s == 0 else acts[(m, s - 1)]
                updates.append((acts, (m, s), fwd_stage(s, h_in)))
            else:
                g_in = (torch.ones(8, dtype=torch.float64) if s == S - 1
                        else grads[(m, s + 1)])
                a = acts[(m, s)]
                updates.append((grads, (m, s),
                                Ws[s].T @ (g_in * (1 - a ** 2))))
        for store, key, val in updates:
            store[key] = val
    for m in range(M):
        torch.testing.assert_close(acts[(m, S - 1)], seq_out[m], rtol=1e-12,
                                   atol=0)
        torch.testing.assert_close(grads[(m, 0)], seq_grad[m], rtol=1e-12,
                                   atol=0)
        np.testing.assert_allclose(acts[(m, S - 1)].numpy(), np_out[m],
                                   rtol=1e-12)
