"""A hand-built configuration that drives the ``cgra_exec`` semantics into
their corners, and scratchpad images to run it on.

No mapper emits this table; it exists to hold the CUDA kernel, its plain
PyTorch version and the JAX reference kernel to the same answer where
implementations usually part: int32 wraparound of ADD/SUB/MUL/SHL, shifts
by 31, 32 and negative amounts, ``ABS(INT_MIN)``, negative and
out-of-range load and store addresses (including a wrapping address add),
a load after a same-cycle store, loop-carried init values before and after
a late ``t0``, a ``t0`` off its slot's residue, the trailing immediate, and
register writes gated by the SOURCE PE's firing.

Layout: II = 2, P = 32, R = 2, scratchpad M >= 256 words.

  * slot 0: PE0 counts iterations; PE1/PE2 load data words 8+i and 20+i;
    PE3 loads an address-like word i; PE4 stores to a+3 and PE5 then
    loads a+3 in the same cycle; PE6 loads a + INT_MIN; PEs 7..30 run one
    ALU opcode each over the loaded values,
  * slot 1: PEs 7..31 store their own latches (PE31: a register) at
    ``40 + 8*j + i``, so the final image holds every result of the last
    iterations.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig)
from repro_torch.core.machine import OPC

II, P, R = 2, 32, 2
MIN_WORDS = 256
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1

#: slot-0 ALU PEs 7..30: (opcode, operands, const, use_const, t0)
_ALU = [
    ("ADD", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("SUB", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("MUL", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("SHL", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("SHR", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("AND", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("OR", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("XOR", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("MIN", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("MAX", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("ABS", [(K_O, 1)], 0, 0, 0),
    ("CMPLT", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("CMPGT", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("CMPEQ", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("CMPNE", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("CMPLE", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("CMPGE", [(K_O, 1), (K_O, 2)], 0, 0, 0),
    ("SELECT", [(K_O, 20), (K_O, 1), (K_O, 2)], 0, 0, 0),
    ("MOVC", [], -5, 0, 3),                    # t0 = 3 lies in slot 1's residue
    ("ROUTE", [(K_R, 26, 0)], 0, 0, 0),        # reads a register
    ("SUB", [(K_O, 1)], INT_MIN, 1, 0),        # trailing immediate, overflow
    ("ADD", [(K_O, 1, 0, 2, INT_MAX), (K_CONST,)], 1, 0, 2),  # init, late t0
    ("SHL", [(K_O, 1)], 31, 1, 0),             # shift by an immediate 31
    ("SHR", [(K_O, 1)], -1, 1, 0),             # shift by -1 -> 31
]


def edge_case_config() -> LinkedConfig:
    """The hand-built lowered configuration (see the module docstring)."""
    scalar = np.zeros((II, P, 4), np.int32)
    ops = np.zeros((II, P, 3, 5), np.int32)
    regw = np.zeros((II, P, R, 3), np.int32)
    scalar[:, :, 3] = -1                         # idle unless set below

    def put(s, p, opc, operands=(), const=0, use_c=0, t0=None):
        scalar[s, p] = (OPC[opc], const, use_c, s if t0 is None else t0)
        for k, o in enumerate(operands):
            kind, pe, reg, dist, init = (tuple(o) + (0, 0, 0, 0))[:5]
            ops[s, p, k] = (kind, pe, reg, dist, init)

    # ---- slot 0: counter, loads, store-then-load, ALU ----------------------
    put(0, 0, "ADD", [(K_O, 0, 0, 1, -1)], const=1, use_c=1)   # i = 0, 1, ..
    put(0, 1, "LOAD", [(K_O, 0)], const=8)                      # x = mem[8+i]
    put(0, 2, "LOAD", [(K_O, 0)], const=20)                     # y = mem[20+i]
    put(0, 3, "LOAD", [(K_O, 0)], const=0)                      # a = mem[i]
    put(0, 4, "STORE", [(K_O, 3), (K_O, 1)], const=3)           # mem[a+3] = x
    put(0, 5, "LOAD", [(K_O, 3)], const=3)                      # sees the store
    put(0, 6, "LOAD", [(K_O, 3)], const=INT_MIN)                # wrapping add
    for j, (opc, operands, const, use_c, t0) in enumerate(_ALU):
        put(0, 7 + j, opc, operands, const=const, use_c=use_c, t0=t0)
    # ---- slot 1: every ALU PE stores its own latch at 40 + 8j + i ----------
    for j in range(len(_ALU)):
        put(1, 7 + j, "STORE", [(K_O, 0), (K_O, 7 + j)], const=40 + 8 * j)
    put(1, 31, "STORE", [(K_O, 0), (K_R, 24, 1)], const=40 + 8 * 24)
    put(1, 5, "STORE", [(K_O, 5)], const=-1)        # value at a bad address

    # ---- register writes ---------------------------------------------------
    regw[0, 26, 0] = (K_RESULT, 9, 0)     # MUL's result, source fires
    regw[0, 26, 1] = (K_RESULT, 31, 0)    # source never fires in slot 0
    regw[0, 25, 1] = (K_RESULT, 28, 0)    # source fires from t0 = 2 on
    regw[1, 25, 0] = (K_O, 9, 0)          # a latch
    regw[0, 24, 1] = (K_R, 25, 1)         # another PE's register
    regw[1, 26, 0] = (K_RESULT, 17, 0)    # a store's result (its value)

    mem_pes = (3, 4, 5, 6, 1, 2) + tuple(range(7, P))
    return LinkedConfig(II=II, n_pes=P, n_regs=R, mem_pes=mem_pes,
                        scalar=scalar, ops=ops, regw=regw)


#: the large-state table: P and R whose per-lane state (P * (1 + R) words
#: and more) exceeds shared memory for even 32 lanes, so the kernel keeps
#: it in global memory; its images need M >= LARGE_MIN_WORDS
LARGE_P, LARGE_R = 128, 16
LARGE_MIN_WORDS = 1024


def large_state_config() -> LinkedConfig:
    """The edge-case table in PEs 0..31 of a P = 128, R = 16 fabric, and
    96 more PEs that use the large register file: in slot 0, PE 32 + j
    XORs an edge-case latch into its register 15 (a K_RESULT write), in
    slot 1 it copies a neighbour's register 15 into its register 3 + j % 12
    (K_R) and stores its register 15 at ``256 + 8*j + i``."""
    edge = edge_case_config()
    P, R = LARGE_P, LARGE_R
    scalar = np.zeros((II, P, 4), np.int32)
    ops = np.zeros((II, P, 3, 5), np.int32)
    regw = np.zeros((II, P, R, 3), np.int32)
    scalar[:, :, 3] = -1
    scalar[:, :edge.n_pes] = edge.scalar
    ops[:, :edge.n_pes] = edge.ops
    regw[:, :edge.n_pes, :edge.n_regs] = edge.regw
    for j in range(P - edge.n_pes):
        p = edge.n_pes + j
        scalar[0, p] = (OPC["XOR"], 0, 0, 0)
        ops[0, p, 0] = (K_R, p, R - 1, 0, 0)
        ops[0, p, 1] = (K_O, 7 + j % len(_ALU), 0, 0, 0)
        regw[0, p, R - 1] = (K_RESULT, p, 0)
        scalar[1, p] = (OPC["STORE"], MIN_WORDS + 8 * j, 0, 1)
        ops[1, p, 0] = (K_O, 0, 0, 0, 0)
        ops[1, p, 1] = (K_R, p, R - 1, 0, 0)
        regw[1, p, 3 + j % 12] = (K_R, edge.n_pes + (j + 1) % (P - edge.n_pes),
                                  R - 1)
    mem_pes = tuple(edge.mem_pes) + tuple(range(edge.n_pes, P))
    return LinkedConfig(II=II, n_pes=P, n_regs=R, mem_pes=mem_pes,
                        scalar=scalar, ops=ops, regw=regw)


def edge_case_images(rng: np.random.Generator, B: int,
                     M: int = MIN_WORDS) -> np.ndarray:
    """(B, M) int32 images: address-like words at [0, 8) (in and out of
    [0, M), negative too), corner-value data at [8, 40), noise above."""
    if M < MIN_WORDS:
        raise ValueError(f"the edge-case table needs M >= {MIN_WORDS}")
    mem = rng.integers(INT_MIN, INT_MAX, size=(B, M), dtype=np.int64)
    mem[:, :8] = rng.integers(-M, 2 * M, size=(B, 8))
    corners = np.array([INT_MIN, INT_MAX, -1, 0, 1, 31, 32, 33, -31, -32,
                        INT_MIN + 1, 1 << 16, -(1 << 16)], np.int64)
    pick = rng.integers(0, 2, size=(B, 32)).astype(bool)
    mem[:, 8:40] = np.where(pick, rng.choice(corners, size=(B, 32)),
                            mem[:, 8:40])
    return mem.astype(np.int32)
