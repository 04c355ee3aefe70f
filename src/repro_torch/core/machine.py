"""Machine-level CGRA configuration ("bitstream") + emission from a mapping.

The mapper's placements and route trees are lowered to per-(slot, PE)
instruction words, exactly what HyCUBE's per-PE configuration memory holds
(paper §III-B-1): ALU opcode + operand selects, crossbar settings, register
writes and an immediate.  The same arrays drive

  * the cycle-accurate simulator (`core/simulator.py`),
  * the CUDA ``cgra_exec`` kernel (`kernels/cgra_exec`) — CM resident on
    the card.

Prologue/epilogue are handled the way PACE's idle-state instructions do it:
every instruction carries its first firing cycle ``t0``; a PE is clock-gated
(idle) for slots whose window has not started, and recurrence operands carry
``(dist, init)`` so iterations ``i < dist`` substitute the initial value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.adl import Fabric
from repro_torch.core.dfg import DFG
from repro_torch.core.mrrg import Route

OPCODES = (
    "NOP", "ADD", "SUB", "MUL", "SHL", "SHR", "AND", "OR", "XOR",
    "MIN", "MAX", "ABS", "CMPLT", "CMPGT", "CMPEQ", "CMPNE", "CMPLE",
    "CMPGE", "SELECT", "MOVC", "LOAD", "STORE", "ROUTE",
)
OPC = {o: i for i, o in enumerate(OPCODES)}

# operand source kinds
SRC_NONE, SRC_REG, SRC_IN, SRC_SELF, SRC_CONST = 0, 1, 2, 3, 4
# crossbar / register-write source kinds
XB_NONE, XB_O, XB_IN, XB_REG = 0, 1, 2, 3


@dataclass
class MachineConfig:
    fabric: Fabric
    II: int
    opcode: np.ndarray        # (S, P) int32
    const: np.ndarray         # (S, P) int32
    use_const: np.ndarray     # (S, P) int32: const is a trailing ALU operand
    t0: np.ndarray            # (S, P) int32, -1 = never fires
    node_id: np.ndarray       # (S, P) int32, -1 = none
    op_src: np.ndarray        # (S, P, 3, 4) int32 [kind, idx, dist, init]
    xbar: np.ndarray          # (S, P, max_out, 2) int32 [kind, idx(globlink/reg)]
    regw: np.ndarray          # (S, P, n_regs, 2) int32 [kind, idx(globlink)]

    @property
    def n_pes(self) -> int:
        return self.fabric.n_pes

    def cm_words(self) -> int:
        """Configuration-memory words per PE (for the energy model)."""
        per_slot = 2 + 3 * 2 + self.xbar.shape[2] + self.regw.shape[2]
        return self.II * per_slot

    def utilization(self) -> float:
        used = int((self.opcode != OPC["NOP"]).sum())
        return used / float(self.II * self.n_pes)


def _slot(t: int, II: int) -> int:
    return t % II


def emit_config(dfg: DFG, fabric: Fabric, II: int,
                placements: Dict[int, Tuple[int, int]],
                routes: List[Route]) -> MachineConfig:
    """Lower placements + routes to the machine configuration."""
    S, P = II, fabric.n_pes
    max_out = max((len(fabric.out_links(p)) for p in range(P)), default=1)
    n_regs = max(a.n_regs for a in fabric.pes)
    cfg = MachineConfig(
        fabric=fabric, II=II,
        opcode=np.full((S, P), OPC["NOP"], np.int32),
        const=np.zeros((S, P), np.int32),
        use_const=np.zeros((S, P), np.int32),
        t0=np.full((S, P), -1, np.int32),
        node_id=np.full((S, P), -1, np.int32),
        op_src=np.zeros((S, P, 3, 4), np.int32),
        xbar=np.zeros((S, P, max_out, 2), np.int32),
        regw=np.zeros((S, P, n_regs, 2), np.int32),
    )
    local_out = {}
    for p in range(P):
        for j, li in enumerate(fabric.out_links(p)):
            local_out[li] = j

    def set_instr(slot, pe, opc, t0, nid, const=0):
        cur = cfg.opcode[slot, pe]
        if cur != OPC["NOP"] and not (cur == OPC[opc] and cfg.t0[slot, pe] == t0):
            raise ValueError(f"FU collision at slot={slot} pe={pe}")
        cfg.opcode[slot, pe] = OPC[opc]
        cfg.t0[slot, pe] = t0
        cfg.node_id[slot, pe] = nid
        cfg.const[slot, pe] = np.int64(const).astype(np.int32)

    def set_xbar(slot, pe, li, kind, idx):
        j = local_out[li]
        cur = cfg.xbar[slot, pe, j]
        if cur[0] != XB_NONE and (cur[0] != kind or cur[1] != idx):
            raise ValueError(f"xbar collision slot={slot} pe={pe} link={li}")
        cfg.xbar[slot, pe, j] = (kind, idx)

    def set_regw(slot, pe, r, kind, idx):
        cur = cfg.regw[slot, pe, r]
        if cur[0] != XB_NONE and (cur[0] != kind or cur[1] != idx):
            raise ValueError(f"regw collision slot={slot} pe={pe} r={r}")
        cfg.regw[slot, pe, r] = (kind, idx)

    # ---- instructions for placed nodes -------------------------------------
    for nid, (pe, t) in placements.items():
        n = dfg.nodes[nid]
        set_instr(_slot(t, II), pe, n.op, t, nid, n.const or 0)
        if n.const is not None and n.op not in ("LOAD", "STORE", "MOVC"):
            cfg.use_const[_slot(t, II), pe] = 1

    # ---- route actions -------------------------------------------------------
    for rt in routes:
        path = rt.path
        for a, b in zip(path[:-1], path[1:]):
            ka, kb = a[0], b[0]
            if ka == "O" and kb == "L":
                _, p, t = a
                set_xbar(_slot(t, II), p, b[1], XB_O, 0)
            elif ka == "R" and kb == "L":
                _, p, r, t = a
                set_xbar(_slot(t, II), p, b[1], XB_REG, r)
            elif ka == "L" and kb == "L":
                li, t = a[1], a[2]
                mid = fabric.links[li][1]
                set_xbar(_slot(t, II), mid, b[1], XB_IN, li)
            elif ka == "L" and kb == "R":
                li, t = a[1], a[2]
                dst = fabric.links[li][1]
                set_regw(_slot(t, II), dst, b[2], XB_IN, li)
            elif ka == "O" and kb == "R":
                _, p, t = a
                # write own result into own register (happens with the latch)
                set_regw(_slot(t - 1, II), p, b[2], XB_O, 0)
            elif ka == "R" and kb == "R":
                pass  # register hold
            elif ka == "R" and kb == "O":
                # N2N ROUTE through the FU
                _, p, r, t = a
                set_instr(_slot(t, II), p, "ROUTE", t, -1)
                cfg.op_src[_slot(t, II), p, 0] = (SRC_REG, r, 0, 0)
            else:
                raise AssertionError(f"bad route transition {a} -> {b}")

    # ---- consumer operand selects ---------------------------------------------
    for rt in routes:
        v = dfg.nodes[rt.sink_node]
        pe, tv = placements[rt.sink_node]
        opnd = v.operands[rt.sink_operand]
        entry = rt.sink_entry
        if entry[0] == "L":
            src = (SRC_IN, entry[1], opnd.dist, opnd.init)
        elif entry[0] == "R":
            src = (SRC_REG, entry[2], opnd.dist, opnd.init)
        else:  # 'O' — same-PE forward
            src = (SRC_SELF, 0, opnd.dist, opnd.init)
        cur = cfg.op_src[_slot(tv, II), pe, rt.sink_operand]
        if cur[0] != SRC_NONE and tuple(cur) != src:
            raise ValueError(f"operand collision node={rt.sink_node}")
        cfg.op_src[_slot(tv, II), pe, rt.sink_operand] = src

    return cfg
