"""Cycle-accurate CGRA simulation (Morpher §III-A-3) — two engines.

``simulate_reference`` is the readable semantics spec: a scalar Python
triple-loop that interprets a ``MachineConfig`` bitstream against one flat
scratchpad image.  Per cycle it resolves crossbar wires (including
HyCUBE's single-cycle multi-hop bypass chains, by relaxing ``max_hops``
times), fires the instruction slot of every PE, and applies register
writes — exactly the semantics the mapper scheduled.  Because the
configuration, not the DFG, is what executes, a mis-scheduled route or
collision produces wrong outputs and is caught by validation against the
DFG interpreter oracle.

``simulate_batch`` is the production engine: it consumes the **lowered
artifact** (``core.lowering.LinkedConfig`` — wire chains resolved once,
at lowering time), precomputes per-slot numpy gather/scatter plans, and
steps a whole batch of scratchpad images through the fabric
simultaneously — all PEs of a cycle execute as array ops over a leading
batch axis.  It is bit-exact against ``simulate_reference`` (proved by
the engine-parity property tests) at a two-to-three-orders-of-magnitude
lower per-sample cost, which is what makes batched validation, DSE and
serving tractable.

PEs outside their instruction's firing window are idle — both engines
report idle-slot statistics, which feed the PACE dynamic clock-gating
energy model, and both record memory-port pressure (worst cycle, ports
used) in ``SimStats`` even when ``check_ports=False``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig)
from repro_torch.core.machine import (MachineConfig, OPC, OPCODES, SRC_CONST,
                                      SRC_IN, SRC_NONE, SRC_REG, SRC_SELF, XB_IN,
                                      XB_NONE, XB_O, XB_REG)

I32 = np.int32


@dataclass
class SimStats:
    cycles: int
    fired: int
    idle_slots: int
    mem_accesses: int
    max_mem_ports_used: int
    #: cycle at which ``max_mem_ports_used`` was first observed (-1: none);
    #: recorded even with ``check_ports=False`` so oversubscription is
    #: diagnosable after the fact instead of only via a mid-run RuntimeError
    worst_port_cycle: int = -1
    #: the fabric's port budget the run was checked against (0 = unknown)
    mem_ports_limit: int = 0

    @property
    def pe_activity(self) -> float:
        total = self.fired + self.idle_slots
        return self.fired / total if total else 0.0

    @property
    def oversubscribed(self) -> bool:
        """Whether any cycle used more memory ports than the fabric has."""
        return (self.mem_ports_limit > 0
                and self.max_mem_ports_used > self.mem_ports_limit)


def _alu(opc: str, ops, const: Optional[int]) -> I32:
    from repro_torch.core.dfg import _eval_op
    return _eval_op(opc, list(ops), const)


def simulate_reference(cfg: MachineConfig, mem: np.ndarray, n_iters: int,
                       check_ports: bool = True
                       ) -> Tuple[np.ndarray, SimStats]:
    """Run the configuration for ``n_iters`` steady-state iterations.

    The scalar reference engine: one sample, pure Python, wire chains
    re-relaxed every cycle.  Kept as the executable semantics spec that
    ``simulate_batch`` (and the CUDA kernel) must match bit-exactly.
    """
    f = cfg.fabric
    II, P = cfg.II, f.n_pes
    n_links = len(f.links)
    n_regs = cfg.regw.shape[2]
    mem = mem.astype(I32).copy()

    out_latch = np.zeros(P, I32)             # PE output latches
    R = np.zeros((P, n_regs), I32)           # input registers
    t_end = int(cfg.t0.max()) + n_iters * II + II + 2
    fired = idle = mem_acc = max_ports = 0
    worst_cycle = -1

    for t in range(t_end):
        s = t % II
        # ---- resolve wires (multi-hop bypass: relax max_hops times) -------
        wires = np.zeros(n_links, I32)
        driven = np.zeros(n_links, bool)
        for _ in range(max(1, f.max_hops)):
            changed = False
            for p in range(P):
                for j, li in enumerate(f.out_links(p)):
                    kind, idx = cfg.xbar[s, p, j]
                    if kind == XB_NONE or driven[li]:
                        continue
                    if kind == XB_O:
                        wires[li] = out_latch[p]
                        driven[li] = True
                        changed = True
                    elif kind == XB_REG:
                        wires[li] = R[p, idx]
                        driven[li] = True
                        changed = True
                    elif kind == XB_IN and driven[idx]:
                        wires[li] = wires[idx]
                        driven[li] = True
                        changed = True
            if not changed:
                break

        # ---- execute instruction slots ------------------------------------
        results: Dict[int, I32] = {}
        ports_used = 0
        for p in range(P):
            opc_i = int(cfg.opcode[s, p])
            t0 = int(cfg.t0[s, p])
            if opc_i == OPC["NOP"] or t0 < 0 or t < t0 or (t - t0) % II:
                idle += 1
                continue
            i = (t - t0) // II
            if i >= n_iters:
                idle += 1
                continue
            fired += 1
            opc = OPCODES[opc_i]
            ops = []
            for k in range(3):
                kind, idx, dist, init = cfg.op_src[s, p, k]
                if kind == SRC_NONE:
                    continue
                if dist > 0 and i < dist:
                    ops.append(I32(init))
                    continue
                if kind == SRC_REG:
                    ops.append(R[p, idx])
                elif kind == SRC_IN:
                    ops.append(wires[idx])
                elif kind == SRC_SELF:
                    ops.append(out_latch[p])
                elif kind == SRC_CONST:
                    ops.append(I32(cfg.const[s, p]))
            const = int(cfg.const[s, p])
            if opc == "LOAD":
                addr = (int(ops[0]) if ops else 0) + const
                results[p] = I32(mem[addr])
                ports_used += 1
                mem_acc += 1
            elif opc == "STORE":
                if len(ops) == 2:
                    addr, val = int(ops[0]) + const, ops[1]
                else:
                    addr, val = const, ops[0]
                mem[addr] = val
                results[p] = val
                ports_used += 1
                mem_acc += 1
            elif opc == "MOVC":
                results[p] = I32(const)
            elif opc == "ROUTE":
                results[p] = ops[0]
            else:
                use_c = bool(cfg.use_const[s, p])
                results[p] = _alu(opc, ops, const if use_c else None)
        if ports_used > max_ports:
            max_ports = ports_used
            worst_cycle = t
        if check_ports and ports_used > f.n_mem_ports:
            raise RuntimeError(f"memory port oversubscription at cycle {t}: "
                               f"{ports_used} > {f.n_mem_ports}")

        # ---- register writes (end of cycle), then output latches ----------
        for p in range(P):
            for r in range(n_regs):
                kind, idx = cfg.regw[s, p, r]
                if kind == XB_NONE:
                    continue
                if kind == XB_IN and driven[idx]:
                    R[p, r] = wires[idx]
                elif kind == XB_O and p in results:
                    R[p, r] = results[p]
        for p, v in results.items():
            out_latch[p] = v

    stats = SimStats(t_end, fired, idle, mem_acc, max_ports,
                     worst_port_cycle=worst_cycle,
                     mem_ports_limit=f.n_mem_ports)
    return mem, stats


#: historical name — the scalar engine was simply ``simulate`` before the
#: vectorized batched engine existed; existing callers keep the reference
#: semantics they were written against
simulate = simulate_reference


# ---------------------------------------------------------------------------
# Vectorized batched engine
# ---------------------------------------------------------------------------

def _vec_alu(opc: str, v0: np.ndarray, v1: np.ndarray,
             v2: np.ndarray) -> np.ndarray:
    """Numpy-vectorized ALU over (N, B) operand blocks, int32 wrapping."""
    if opc == "ADD":
        return v0 + v1
    if opc == "SUB":
        return v0 - v1
    if opc == "MUL":
        return v0 * v1
    if opc == "SHL":
        return v0 << (v1 & I32(31))
    if opc == "SHR":
        return v0 >> (v1 & I32(31))
    if opc == "AND":
        return v0 & v1
    if opc == "OR":
        return v0 | v1
    if opc == "XOR":
        return v0 ^ v1
    if opc == "MIN":
        return np.minimum(v0, v1)
    if opc == "MAX":
        return np.maximum(v0, v1)
    if opc == "ABS":
        return np.abs(v0)
    if opc == "CMPLT":
        return (v0 < v1).astype(I32)
    if opc == "CMPGT":
        return (v0 > v1).astype(I32)
    if opc == "CMPEQ":
        return (v0 == v1).astype(I32)
    if opc == "CMPNE":
        return (v0 != v1).astype(I32)
    if opc == "CMPLE":
        return (v0 <= v1).astype(I32)
    if opc == "CMPGE":
        return (v0 >= v1).astype(I32)
    if opc == "SELECT":
        return np.where(v0 != 0, v1, v2)
    if opc == "ROUTE":
        return v0
    raise AssertionError(f"unvectorized opcode {opc}")


class _SlotPlan:
    """Precomputed gather/scatter plan for one II slot of a LinkedConfig.

    Everything data-independent is resolved here, once: operand source
    rows into the stacked (O ++ R) state, the trailing-immediate fill,
    ALU opcode groups, the ordered memory-op list and the register-write
    scatter.  Per cycle only the firing window (a function of ``t``) and
    the actual array ops remain.
    """

    __slots__ = ("opc", "const", "t0", "src_row", "is_state", "is_const",
                 "dist", "init", "alu_groups", "movc_idx", "mem_ops",
                 "rw_state_rows", "rw_state_src", "rw_res_rows", "rw_res_pe")

    def __init__(self, linked: LinkedConfig, s: int):
        P, R = linked.n_pes, linked.n_regs
        sc = linked.scalar[s]
        tab = linked.ops[s]
        self.opc = sc[:, 0].copy()
        self.const = sc[:, 1].copy()
        self.t0 = sc[:, 3].copy()
        use_c = sc[:, 2] != 0

        kind = tab[:, :, 0]                      # (P, 3)
        n_ops = (kind != K_NONE).sum(axis=1)     # (P,)
        # operand k reads row ``src_row`` of the stacked state
        # [O (P rows) ++ R (P*R rows)]; const/none slots read row 0 (masked)
        self.src_row = np.where(
            kind == K_O, tab[:, :, 1],
            np.where(kind == K_R, P + tab[:, :, 1] * R + tab[:, :, 2], 0))
        self.is_state = (kind == K_O) | (kind == K_R)
        # the immediate is a *trailing* ALU operand when use_const is set:
        # it fills the first absent slot after the real operands
        k_idx = np.arange(3)[None, :]
        self.is_const = (kind == K_CONST) | ((kind == K_NONE)
                                             & use_c[:, None]
                                             & (n_ops[:, None] == k_idx))
        self.dist = tab[:, :, 3].copy()
        self.init = tab[:, :, 4].copy()

        # ---- ALU opcode groups (mem ops handled separately, in PE order) --
        self.alu_groups: List[Tuple[str, np.ndarray]] = []
        self.movc_idx = np.nonzero(self.opc == OPC["MOVC"])[0]
        special = {OPC["NOP"], OPC["LOAD"], OPC["STORE"], OPC["MOVC"]}
        for code in np.unique(self.opc):
            if int(code) in special:
                continue
            idx = np.nonzero(self.opc == code)[0]
            self.alu_groups.append((OPCODES[int(code)], idx))

        # ---- memory ops: ascending PE order == reference engine order -----
        self.mem_ops: List[Tuple[int, bool, bool, int]] = []
        for p in range(P):
            if self.opc[p] == OPC["LOAD"]:
                self.mem_ops.append((p, True, kind[p, 0] != K_NONE,
                                     int(self.const[p])))
            elif self.opc[p] == OPC["STORE"]:
                self.mem_ops.append((p, False, kind[p, 1] != K_NONE,
                                     int(self.const[p])))

        # ---- register writes: flat scatter into the stacked state ---------
        # register (p, r) lives at stacked-state row P + p*R + r
        rw = linked.regw[s].reshape(P * R, 3)
        rwk, rwp, rwr = rw[:, 0], rw[:, 1], rw[:, 2]
        state_mask = (rwk == K_O) | (rwk == K_R)
        self.rw_state_rows = P + np.nonzero(state_mask)[0]
        self.rw_state_src = np.where(rwk == K_O, rwp, P + rwp * R + rwr
                                     )[state_mask]
        res_mask = rwk == K_RESULT
        self.rw_res_rows = P + np.nonzero(res_mask)[0]
        self.rw_res_pe = rwp[res_mask]


class BatchedSimulator:
    """Vectorized execution engine over a lowered artifact.

    Construct once per ``LinkedConfig`` (plans are precomputed per slot),
    then ``run`` arbitrarily many batches: the state carries a trailing
    batch axis, so ``B`` scratchpad images step through the fabric
    simultaneously and each cycle is a handful of numpy array ops instead
    of a Python loop over PEs and links.
    """

    def __init__(self, linked: LinkedConfig):
        self.linked = linked
        self.plans = [_SlotPlan(linked, s) for s in range(linked.II)]

    def run(self, mems: np.ndarray, n_iters: int,
            check_ports: bool = True) -> Tuple[np.ndarray, SimStats]:
        """Execute a (B, M) batch of scratchpad images for ``n_iters``
        steady-state iterations; returns ((B, M) images, per-sample stats).

        Firing, idling and port pressure are functions of the (static)
        configuration and the cycle alone, so ``SimStats`` is identical
        for every sample in the batch — and identical to the reference
        engine's stats for one sample.
        """
        linked = self.linked
        II, P, R = linked.II, linked.n_pes, linked.n_regs
        mems = np.ascontiguousarray(mems, dtype=I32)
        if mems.ndim != 2:
            raise ValueError(f"simulate_batch expects (B, M) images, "
                             f"got shape {mems.shape}")
        B = mems.shape[0]
        mem = mems.copy()
        lanes = np.arange(B)
        state = np.zeros((P + P * R, B), I32)   # [O latches ++ registers]
        t_end = linked.total_cycles(n_iters)
        fired_n = mem_acc = max_ports = 0
        worst_cycle = -1
        limit = linked.n_mem_ports

        with np.errstate(over="ignore"):
            for t in range(t_end):
                pl = self.plans[t % II]
                it = np.where(pl.t0 >= 0, (t - pl.t0) // II, 0)
                fire = ((pl.opc != OPC["NOP"]) & (pl.t0 >= 0)
                        & (t >= pl.t0) & (it < n_iters))
                n_fire = int(fire.sum())
                fired_n += n_fire
                if n_fire == 0:
                    # no PE fires, but route pipelines crossing this slot
                    # still shift: wire-fed register writes read pre-cycle
                    # state (numpy evaluates the RHS gather before the
                    # scatter, so in-place is the simultaneous semantics)
                    if len(pl.rw_state_rows):
                        state[pl.rw_state_rows] = state[pl.rw_state_src]
                    continue

                # ---- operand fetch: one static gather per operand slot ---
                cvec = np.broadcast_to(pl.const[:, None], (P, B))
                vs = []
                for k in range(3):
                    v = np.where(pl.is_state[:, k, None],
                                 state[pl.src_row[:, k]], I32(0))
                    v = np.where(pl.is_const[:, k, None], cvec, v)
                    use_init = (pl.dist[:, k] > 0) & (it < pl.dist[:, k])
                    v = np.where(use_init[:, None],
                                 pl.init[:, k, None].astype(I32), v)
                    vs.append(v)
                v0, v1, v2 = vs

                # ---- ALU: one vector op per opcode present in the slot ---
                result = np.zeros((P, B), I32)
                for opc, idx in pl.alu_groups:
                    result[idx] = _vec_alu(opc, v0[idx], v1[idx], v2[idx])
                if len(pl.movc_idx):
                    result[pl.movc_idx] = cvec[pl.movc_idx]

                # ---- memory ops: ascending PE order (reference order) ----
                ports_used = 0
                for p, is_load, has_idx, const in pl.mem_ops:
                    if not fire[p]:
                        continue
                    ports_used += 1
                    mem_acc += 1
                    if is_load:
                        addr = (v0[p] if has_idx else I32(0)) + const
                        result[p] = mem[lanes, addr]
                    else:
                        if has_idx:                 # [addr_operand, value]
                            addr, val = v0[p] + const, v1[p]
                        else:                       # [value] @ immediate
                            addr = np.full(B, const, I32)
                            val = v0[p]
                        mem[lanes, addr] = val
                        result[p] = val
                if ports_used > max_ports:
                    max_ports = ports_used
                    worst_cycle = t
                # guard semantics (explicit contract, tested in
                # tests/test_verifier.py): ``linked.n_mem_ports == 0``
                # means *unknown/unbounded* — the oversubscription check
                # is disabled entirely (`limit and ...` short-circuits),
                # while pressure is still recorded in SimStats above.
                # ``link_config`` threads the fabric's real limit through
                # unconditionally, so 0 only appears on hand-built
                # tables; the static verifier flags it as UAL011
                if check_ports and limit and ports_used > limit:
                    raise RuntimeError(
                        f"memory port oversubscription at cycle {t}: "
                        f"{ports_used} > {limit}")

                # ---- end of cycle: register writes, then output latches --
                new_state = state.copy()
                if len(pl.rw_state_rows):
                    new_state[pl.rw_state_rows] = state[pl.rw_state_src]
                if len(pl.rw_res_rows):
                    live = fire[pl.rw_res_pe]
                    rows = pl.rw_res_rows[live]
                    new_state[rows] = result[pl.rw_res_pe[live]]
                new_state[:P] = np.where(fire[:, None], result, state[:P])
                state = new_state

        stats = SimStats(t_end, fired_n, t_end * P - fired_n, mem_acc,
                         max_ports, worst_port_cycle=worst_cycle,
                         mem_ports_limit=limit)
        return mem, stats


def batched_engine(linked: LinkedConfig) -> BatchedSimulator:
    """The (memoized) vectorized engine for a lowered artifact: plans are
    precomputed once per LinkedConfig and reused across runs/backends."""
    eng = getattr(linked, "_engine", None)
    if eng is None:
        eng = BatchedSimulator(linked)
        linked._engine = eng
    return eng


def simulate_batch(linked: LinkedConfig, mems: np.ndarray, n_iters: int,
                   check_ports: bool = True) -> Tuple[np.ndarray, SimStats]:
    """Vectorized batched simulation of a lowered artifact.

    ``mems``: (B, M) int32 scratchpad images -> ((B, M) final images,
    per-sample ``SimStats``).  Bit-exact against ``simulate_reference``
    run per sample.
    """
    return batched_engine(linked).run(mems, n_iters, check_ports=check_ports)
