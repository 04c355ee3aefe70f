"""Pipeline-parallel schedules derived from the paper's modulo framework.

A software-pipelined loop on a CGRA and a pipeline-parallel training step
are the same object: *stages* are FUs, a *microbatch* is a loop iteration,
and the initiation interval II is the number of ticks between consecutive
microbatch injections.  This module reuses the reservation-table algebra of
the CGRA mapper to derive classic training schedules (GPipe, 1F1B,
interleaved 1F1B) plus a generic modulo scheduler, and computes their
bubble fraction and activation-memory footprint.

The schedules are *verified* the same way CGRA mappings are: an interpreter
replays the reservation table and checks every dependence
(fwd(m,s) -> fwd(m,s+1), fwd(m,S-1) -> bwd(m,S-1), bwd(m,s) -> bwd(m,s-1)),
and `tests/test_torch_pipeline_schedule.py` additionally executes a toy
model in torch under the schedule and compares against sequential
execution.  Pure Python: the same schedules as the JAX package's
``repro.core.pipeline_schedule``, slot for slot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

FWD, BWD = "F", "B"
Slot = Tuple[str, int, int]   # (phase, microbatch, chunk/virtual-stage)


@dataclass
class PipelineSchedule:
    name: str
    n_stages: int
    n_microbatches: int
    n_chunks: int                          # virtual stages per device
    table: List[List[Optional[Slot]]]      # [t][stage] -> slot or None
    fwd_cost: float = 1.0
    bwd_cost: float = 2.0

    # -- analytics (the CGRA mapper's II / utilization, renamed) -----------
    @property
    def total_ticks(self) -> int:
        return len(self.table)

    @property
    def steady_ii(self) -> float:
        """Ticks per microbatch in steady state (CGRA II analogue)."""
        work = self.n_chunks * (1 + 1)     # one fwd + one bwd slot per chunk
        return work

    def bubble_fraction(self) -> float:
        total = self.total_ticks * self.n_stages
        busy = sum(1 for row in self.table for s in row if s is not None)
        return 1.0 - busy / total

    def weighted_bubble_fraction(self) -> float:
        """Bubble fraction with fwd/bwd slot costs (tb != tf)."""
        cost = {FWD: self.fwd_cost, BWD: self.bwd_cost}
        span = 0.0
        busy = 0.0
        for row in self.table:
            tick_cost = max((cost[s[0]] for s in row if s is not None),
                            default=0.0)
            span += tick_cost * self.n_stages
            busy += sum(cost[s[0]] for s in row if s is not None)
        return 1.0 - busy / span if span else 1.0

    def peak_in_flight(self) -> int:
        """Max live activations (microbatches awaiting bwd) on any stage."""
        peak = 0
        live: Dict[int, set] = {s: set() for s in range(self.n_stages)}
        for row in self.table:
            for s, slot in enumerate(row):
                if slot is None:
                    continue
                phase, m, c = slot
                if phase == FWD:
                    live[s].add((m, c))
                else:
                    live[s].discard((m, c))
                peak = max(peak, len(live[s]))
        return peak

    # -- validation -----------------------------------------------------------
    def verify(self) -> None:
        """Replay the table and check every dependence edge (raises on bugs)."""
        S, M, C = self.n_stages, self.n_microbatches, self.n_chunks
        done: Dict[Tuple, int] = {}
        for t, row in enumerate(self.table):
            for s, slot in enumerate(row):
                if slot is None:
                    continue
                phase, m, c = slot
                key = (phase, m, c, s)
                if key in done:
                    raise AssertionError(f"slot {key} scheduled twice")
                # global position in the fwd chain: chunk-major over stages
                pos = c * S + s
                if phase == FWD:
                    if pos > 0:
                        p_s, p_c = (pos - 1) % S, (pos - 1) // S
                        if done.get((FWD, m, p_c, p_s), 1 << 30) >= t:
                            raise AssertionError(
                                f"fwd dep violated m={m} pos={pos} t={t}")
                else:
                    if pos == S * C - 1:
                        if done.get((FWD, m, c, s), 1 << 30) >= t:
                            raise AssertionError(
                                f"fwd->bwd dep violated m={m} t={t}")
                    else:
                        n_s, n_c = (pos + 1) % S, (pos + 1) // S
                        if done.get((BWD, m, n_c, n_s), 1 << 30) >= t:
                            raise AssertionError(
                                f"bwd dep violated m={m} pos={pos} t={t}")
                done[key] = t
        want = S * M * C
        fwd_done = sum(1 for k in done if k[0] == FWD)
        bwd_done = sum(1 for k in done if k[0] == BWD)
        if fwd_done != want or bwd_done != want:
            raise AssertionError(
                f"incomplete schedule: fwd {fwd_done}/{want}, bwd {bwd_done}/{want}")


# ---------------------------------------------------------------------------
# Schedule constructors
# ---------------------------------------------------------------------------

def _empty(n_ticks: int, S: int) -> List[List[Optional[Slot]]]:
    return [[None] * S for _ in range(n_ticks)]


def gpipe(n_stages: int, n_microbatches: int) -> PipelineSchedule:
    S, M = n_stages, n_microbatches
    ticks = (M + S - 1) * 2
    tbl = _empty(ticks, S)
    for m in range(M):
        for s in range(S):
            tbl[m + s][s] = (FWD, m, 0)
    base = M + S - 1
    for m in range(M):
        for s in reversed(range(S)):
            tbl[base + m + (S - 1 - s)][s] = (BWD, m, 0)
    return PipelineSchedule("gpipe", S, M, 1, tbl)


def one_f_one_b(n_stages: int, n_microbatches: int) -> PipelineSchedule:
    """1F1B: same bubble as GPipe, activation memory capped at S in-flight.

    Built with a greedy list scheduler over the dependence graph — the same
    mechanism the CGRA mapper uses (ready ops + resource slots), with the
    1F1B policy 'prefer BWD when available' providing the priority function.
    """
    S, M = n_stages, n_microbatches
    tbl: List[List[Optional[Slot]]] = []
    fwd_done = [[-1] * S for _ in range(M)]     # tick when fwd(m,s) completed
    bwd_done = [[-1] * S for _ in range(M)]
    nf = [0] * S                                 # next microbatch to fwd, per stage
    t = 0
    total = 2 * S * M
    scheduled = 0
    warmup = [min(S - s, M) for s in range(S)]   # fwd's before first bwd
    while scheduled < total and t < 8 * (S + M) * 2:
        row: List[Optional[Slot]] = [None] * S
        for s in range(S):
            # candidate BWD: earliest microbatch whose successor bwd is done
            bm = None
            for m in range(M):
                if bwd_done[m][s] >= 0:
                    continue
                if fwd_done[m][s] < 0 or fwd_done[m][s] >= t:
                    continue
                if s == S - 1 or (bwd_done[m][s + 1] >= 0
                                  and bwd_done[m][s + 1] < t):
                    bm = m
                    break
            fm = None
            m = nf[s]
            if m < M and (s == 0 or (fwd_done[m][s - 1] >= 0
                                     and fwd_done[m][s - 1] < t)):
                fm = m
            # 1F1B policy: after warmup, prefer BWD
            fwds_issued = nf[s]
            if bm is not None and (fwds_issued >= warmup[s] or fm is None):
                row[s] = (BWD, bm, 0)
                bwd_done[bm][s] = t
            elif fm is not None:
                row[s] = (FWD, fm, 0)
                fwd_done[fm][s] = t
                nf[s] += 1
            if row[s] is not None:
                scheduled += 1
        tbl.append(row)
        t += 1
    sched = PipelineSchedule("1f1b", S, M, 1, tbl)
    return sched


def interleaved_1f1b(n_stages: int, n_microbatches: int,
                     n_chunks: int = 2) -> PipelineSchedule:
    """Interleaved (virtual-stage) 1F1B — bubble shrinks by ~1/n_chunks.

    Greedy list scheduling over the chunked dependence chain with the
    'deepest-ready-bwd first, then earliest-ready-fwd' priority.
    """
    S, M, C = n_stages, n_microbatches, n_chunks
    fwd_done: Dict[Tuple[int, int, int], int] = {}
    bwd_done: Dict[Tuple[int, int, int], int] = {}
    tbl: List[List[Optional[Slot]]] = []
    total = 2 * S * M * C
    scheduled = 0
    issued_f = {s: 0 for s in range(S)}
    t = 0
    warm = [(C + 1) * S - 2 * s - 1 for s in range(S)]   # Megatron warmup rule
    while scheduled < total and t < 16 * (S + M) * C:
        row: List[Optional[Slot]] = [None] * S
        for s in range(S):
            # ready BWD on this stage: deepest chunk first, earliest microbatch
            bcand: List[Tuple[int, int]] = []
            for c in reversed(range(C)):
                pos = c * S + s
                for m in range(M):
                    if (m, c, s) in bwd_done:
                        continue
                    if fwd_done.get((m, c, s), 1 << 30) >= t:
                        continue
                    if pos == S * C - 1:
                        bcand.append((m, c))
                        break
                    n_s, n_c = (pos + 1) % S, (pos + 1) // S
                    if bwd_done.get((m, n_c, n_s), 1 << 30) < t:
                        bcand.append((m, c))
                        break
                if bcand:
                    break
            # ready FWD: earliest chunk first, earliest microbatch
            fcand: List[Tuple[int, int]] = []
            for c in range(C):
                pos = c * S + s
                for m in range(M):
                    if (m, c, s) in fwd_done:
                        continue
                    if pos == 0:
                        fcand.append((m, c))
                        break
                    p_s, p_c = (pos - 1) % S, (pos - 1) // S
                    if fwd_done.get((m, p_c, p_s), 1 << 30) < t:
                        fcand.append((m, c))
                        break
                if fcand:
                    break
            if bcand and (issued_f[s] >= warm[s] or not fcand):
                m, c = bcand[0]
                row[s] = (BWD, m, c)
                bwd_done[(m, c, s)] = t
            elif fcand:
                m, c = fcand[0]
                row[s] = (FWD, m, c)
                fwd_done[(m, c, s)] = t
                issued_f[s] += 1
            if row[s] is not None:
                scheduled += 1
        tbl.append(row)
        t += 1
    return PipelineSchedule(f"interleaved_1f1b_c{C}", S, M, C, tbl)


SCHEDULERS = {
    "gpipe": gpipe,
    "1f1b": one_f_one_b,
    "interleaved": interleaved_1f1b,
}


def bubble_model(n_stages: int, n_microbatches: int, n_chunks: int = 1,
                 tf: float = 1.0, tb: float = 2.0) -> float:
    """Closed-form bubble fraction (the RecMII-style analytic bound)."""
    S, M, C = n_stages, n_microbatches, n_chunks
    return (S - 1) * (tf + tb) / (C * M * (tf + tb) + (S - 1) * (tf + tb))
