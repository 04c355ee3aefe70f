"""Public wrapper: lowered tables + scratchpad block -> the CUDA kernel.

``cgra_exec(tables, memT, n_iters)`` launches the hand-written kernel
(``csrc/cgra_exec.cu``) when ``memT`` lies on a CUDA device and raises if it
cannot; only a CPU tensor goes to the plain PyTorch version
(``ref.cgra_exec_torch``).  ``upload_tables`` packs a ``LinkedConfig`` once
(``pack_tables``: per II slot, the PEs that can fire with their operands
decoded, the LOAD/STORE PEs in port order, the live register writes) and
puts the packed form on a device; the execution engine keeps it there.  The
dense tables stay on the ``LinkedConfig``, where the plain version reads
them; ``unpack_tables`` expands the packed form back to dense tables, so the
CPU tests can hold the packing to them.

``plan_launch`` chooses the kernel's geometry (32 lanes x ``warps`` warps a
group, ``groups`` groups a block) and its form: per-lane state and tables in
shared memory where they fit, else the tables read from global memory
through the read-only path, else the state in a global scratch too.  Size
never decides whether the kernel launches.

Every launch adds one to the module's launch count (``launches()``), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lowering
from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig, config_fingerprint,
                                       link_config)
from repro_torch.core.machine import OPC, MachineConfig
from repro_torch.kernels import build as _build
from repro_torch.kernels.cgra_exec.ref import cgra_exec_torch

SOURCES = (Path(__file__).resolve().parent / "csrc" / "cgra_exec.cu",)

#: int32 words of one packed record: a slot's header, a firing PE, an ALU
#: PE, a memory PE, a register write (multiples of 4: the kernel reads
#: records as int4).  The same numbers are -D flags of the build.
HDR_WORDS, FIRE_WORDS, ALU_WORDS, MEM_WORDS, RW_WORDS = 16, 4, 16, 12, 4
#: shared memory one block may use on Hopper (227 KB, opt-in above 48 KB)
SMEM_BUDGET = 232448
#: the most threads a block of the kernel has (its __launch_bounds__)
MAX_THREADS = 256
#: the geometry the kernel launches with unless the caller names one:
#: one group of 32 lanes a block, its cycle spread over 8 warps
DEFAULT_GROUPS, DEFAULT_WARPS = 1, 8

_launches = 0
_count_lock = threading.Lock()


def launches() -> int:
    """Kernel launches since the last ``reset_launches`` (CUDA only)."""
    with _count_lock:
        return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def defines() -> Dict[str, int]:
    """The ``-D`` flags the kernel is built with: opcode numbers from
    ``core.machine.OPC``, the lowered source kinds and the packed record
    sizes, never hand-copied."""
    d = {f"OPC_{name}": code for name, code in OPC.items()}
    d.update({k: getattr(lowering, k) for k in
              ("K_NONE", "K_O", "K_R", "K_CONST", "K_RESULT")})
    d.update(HDR_WORDS=HDR_WORDS, FIRE_WORDS=FIRE_WORDS, ALU_WORDS=ALU_WORDS,
             MEM_WORDS=MEM_WORDS, RW_WORDS=RW_WORDS, MAX_THREADS=MAX_THREADS)
    return d


def build() -> Path:
    """Build the kernel library (no-op when it exists); returns its path."""
    return _build.build("cgra_exec", SOURCES, defines())


@functools.cache
def _launcher():
    """The library's C entry point, built and loaded once per process:
    hashing the sources on every launch would cost host time that small
    launches (the engine's low buckets) cannot hide."""
    fn = _build.load("cgra_exec", SOURCES, defines()).cgra_exec_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# the packed form
# ---------------------------------------------------------------------------

def _i32(x: int) -> int:
    """The int32 value with the low 32 bits of ``x``."""
    return ((int(x) + (1 << 31)) & ((1 << 32) - 1)) - (1 << 31)


@dataclass(frozen=True)
class PackedTables:
    """The per-slot compact form of a ``LinkedConfig`` that the kernel reads.

    ``words`` is one int32 array, every record 16-byte aligned:
      * per slot s, a header of HDR_WORDS: ``n_fire, fire_off, n_alu,
        alu_off, n_mem, mem_off, n_stage, n_rw, rw_off`` (offsets in words);
      * firing records ``(pe, d)``: the PEs whose opcode is not NOP and
        whose t0 >= 0, in PE order; the record's index j is the PE's row
        in this cycle's results.  A PE fires at cycle t = q * II + s when
        0 <= q + d < n_iters, and q + d is its iteration ``it``
        (d = floor((s - t0) / II));
      * ALU records ``(j, opcode, d, const)`` and three operands
        ``(src, imm, dist, init)``: the value is ``init`` where
        ``dist > 0 and it < dist``, else state row ``src`` (output latches
        at [0, P), registers at [P, P + P*R)) or, where src < 0, ``imm``
        (the immediate, the trailing immediate, or 0);
      * memory records, the LOAD/STORE PEs of ``mem_pes`` in port order:
        ``(j, is_store | has << 1, const, d)`` and operands v0, v1, with
        ``has`` whether the LOAD has an index, the STORE a second operand;
      * register writes ``(dst, src, d, 0)`` with dst the register's state
        row: first the ``n_stage`` that copy a latch or register (src a
        state row, or -1 for 0), then the K_RESULT writes (src the source
        PE's firing record j, d its firing offset).
    ``n_fire`` and ``n_stage`` are the most any slot has: the rows of
    results and staged register values a lane needs.
    """

    words: np.ndarray
    II: int
    n_pes: int
    n_regs: int
    n_fire: int
    n_stage: int

    @property
    def state_rows(self) -> int:
        """Per-lane state, in words: latches, registers, this cycle's
        results, staged register writes."""
        return (self.n_pes * (1 + self.n_regs) + self.n_fire
                + self.n_stage)

    def slot(self, s: int) -> Dict[str, np.ndarray]:
        """Slot ``s``'s records, one (n, record words) array per kind."""
        w = self.words
        n_fire, fo, n_alu, ao, n_mem, mo, n_stage, n_rw, ro = \
            (int(v) for v in w[s * HDR_WORDS:s * HDR_WORDS + 9])
        return {
            "fire": w[fo:fo + n_fire * FIRE_WORDS].reshape(-1, FIRE_WORDS),
            "alu": w[ao:ao + n_alu * ALU_WORDS].reshape(-1, ALU_WORDS),
            "mem": w[mo:mo + n_mem * MEM_WORDS].reshape(-1, MEM_WORDS),
            "rw": w[ro:ro + n_rw * RW_WORDS].reshape(-1, RW_WORDS),
            "n_stage": n_stage,
        }


def _operands(ops_row, const: int, use_const: int, P: int, R: int
              ) -> List[Tuple[int, int, int, int]]:
    """A PE's three operands decoded to ``(src, imm, dist, init)``: what
    ``csrc/cgra_exec.cu:66-78`` says each reads."""
    kinds = [int(o[0]) for o in ops_row]
    n_ops = sum(k != K_NONE for k in kinds)
    out = []
    for k, (kind, pe, reg, dist, init) in enumerate(ops_row):
        kind, pe, reg = int(kind), int(pe), int(reg)
        src, imm = -1, 0
        if kind == K_O:
            src = pe if 0 <= pe < P else -1
        elif kind == K_R:
            idx = _i32(pe * R + reg)
            src = P + idx if 0 <= idx < P * R else -1
        elif kind == K_CONST:
            imm = const
        dist, init = int(dist), int(init)
        if use_const and kind == K_NONE and n_ops == k:
            src, imm, dist, init = -1, const, 0, 0   # the trailing immediate
        out.append((src, imm, dist, init))
    return out


def pack_tables(linked: LinkedConfig) -> PackedTables:
    """Pack ``linked``'s dense tables into the per-slot form the kernel
    reads (host code, once per engine)."""
    II, P, R = linked.II, linked.n_pes, linked.n_regs
    scalar = np.asarray(linked.scalar)
    optab = np.asarray(linked.ops)
    regw = np.asarray(linked.regw)
    memory = (OPC["LOAD"], OPC["STORE"])
    mem_pes = [int(p) for p in linked.mem_pes]
    on_port = set(mem_pes)
    slots = []
    for s in range(II):
        fire, alu, mem, stage, result = [], [], [], [], []
        row_of: Dict[int, Tuple[int, int]] = {}
        for p in range(P):
            opc, const, use_c, t0 = (int(v) for v in scalar[s, p])
            if opc == OPC["NOP"] or t0 < 0:
                continue
            d = (s - t0) // II
            j = len(fire)
            row_of[p] = (j, d)
            fire.append((p, d, 0, 0))
            if opc in memory and p in on_port:
                continue                       # the memory pass sets it
            alu.append((j, opc, d, const) + sum(
                _operands(optab[s, p], const, use_c, P, R), ()))
        for p in mem_pes:
            opc, const, use_c, _ = (int(v) for v in scalar[s, p])
            if opc not in memory or p not in row_of:
                continue
            j, d = row_of[p]
            store = int(opc == OPC["STORE"])
            has = int(int(optab[s, p, store, 0]) != K_NONE)
            v0, v1, _ = _operands(optab[s, p], const, use_c, P, R)
            mem.append((j, store | has << 1, const, d) + v0 + v1)
        for p in range(P):
            for r in range(R):
                kind, sp, reg = (int(v) for v in regw[s, p, r])
                dst = P + p * R + r
                if kind == K_O:
                    stage.append((dst, sp if 0 <= sp < P else -1, 0, 0))
                elif kind == K_R:
                    idx = _i32(sp * R + reg)
                    stage.append((dst, P + idx if 0 <= idx < P * R else -1,
                                  0, 0))
                elif kind == K_RESULT and sp in row_of:
                    j, d = row_of[sp]
                    result.append((dst, j, d, 0))
        slots.append((fire, alu, mem, stage, result))

    words: List[int] = [0] * (II * HDR_WORDS)
    for s, (fire, alu, mem, stage, result) in enumerate(slots):
        offs = []
        for records in (fire, alu, mem, stage + result):
            offs.append(len(words))
            for rec in records:
                words.extend(_i32(v) for v in rec)
        words[s * HDR_WORDS:s * HDR_WORDS + 9] = [
            len(fire), offs[0], len(alu), offs[1], len(mem), offs[2],
            len(stage), len(stage) + len(result), offs[3]]
    return PackedTables(
        words=np.asarray(words, np.int32), II=II, n_pes=P, n_regs=R,
        n_fire=max(len(f) for f, *_ in slots),
        n_stage=max(len(st) for *_, st, _ in slots))


def unpack_tables(packed: PackedTables
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             List[Tuple[int, ...]]]:
    """Expand the packed form back to dense ``(scalar, ops, regw)`` tables
    and the memory PEs of each slot in port order.  Entries the kernel
    never reads come back in a canonical form: an idle PE is NOP with
    t0 = -1, a PE's t0 is s - d * II (the first cycle of slot s at which
    it fires), each operand is a kind that reads the same value, with the
    trailing immediate folded in (use_const = 0), and an idle register
    write is K_NONE."""
    II, P, R = packed.II, packed.n_pes, packed.n_regs
    scalar = np.zeros((II, P, 4), np.int32)
    optab = np.zeros((II, P, 3, 5), np.int32)
    regw = np.zeros((II, P, R, 3), np.int32)
    scalar[:, :, 3] = -1
    mem_order = []

    def operand(src, imm, dist, init, const):
        if 0 <= src < P:
            return (K_O, src, 0, dist, init)
        if P <= src < P + P * R:
            return (K_R, (src - P) // R, (src - P) % R, dist, init)
        # an out-of-range latch reads 0 and still counts as present
        return ((K_CONST, 0, 0, dist, init) if imm == const
                else (K_O, -1, 0, dist, init))

    for s in range(II):
        rec = packed.slot(s)
        fire = rec["fire"]
        for e in rec["alu"]:
            j, opc, d, const = (int(v) for v in e[:4])
            p = int(fire[j, 0])
            scalar[s, p] = (opc, const, 0, s - d * II)
            for k in range(3):
                optab[s, p, k] = operand(*(int(v) for v in
                                           e[4 + 4 * k:8 + 4 * k]), const)
        order = []
        for e in rec["mem"]:
            j, flags, const, d = (int(v) for v in e[:4])
            store, has = flags & 1, flags >> 1
            p = int(fire[j, 0])
            order.append(p)
            scalar[s, p] = (OPC["STORE"] if store else OPC["LOAD"], const, 0,
                            s - d * II)
            for k in range(2):
                optab[s, p, k] = operand(*(int(v) for v in
                                           e[4 + 4 * k:8 + 4 * k]), const)
            if not has:                     # no index / no second operand
                optab[s, p, store] = (K_NONE, 0, 0, 0, 0)
        mem_order.append(tuple(order))
        for k, (dst, src, _, _) in enumerate(rec["rw"]):
            p, r = divmod(int(dst) - P, R)
            if k >= rec["n_stage"]:
                regw[s, p, r] = (K_RESULT, int(fire[src, 0]), 0)
            elif 0 <= src < P:
                regw[s, p, r] = (K_O, src, 0)
            elif src >= P:
                regw[s, p, r] = (K_R, (src - P) // R, (src - P) % R)
            else:
                regw[s, p, r] = (K_O, -1, 0)
    return scalar, optab, regw, mem_order


# ---------------------------------------------------------------------------
# tables on the device, and the launch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceTables:
    """A lowered artifact on one device: the packed form the kernel reads
    (``packed`` on the device, ``layout`` its sizes); the dense tables stay
    on ``linked`` for the plain version."""

    linked: LinkedConfig
    device: torch.device
    layout: PackedTables
    packed: torch.Tensor      # (words,) int32


def upload_tables(linked: LinkedConfig, device) -> DeviceTables:
    """Check ``linked``'s tables, pack them and copy the packed form to
    ``device`` once."""
    device = torch.device(device)
    S, P, R = linked.II, linked.n_pes, linked.n_regs
    want = {"scalar": (S, P, 4), "ops": (S, P, 3, 5), "regw": (S, P, R, 3)}
    for name, shape in want.items():
        got = np.shape(getattr(linked, name))
        if got != shape:
            raise ValueError(f"linked.{name} has shape {got}, expected "
                             f"{shape} for II={S}, P={P}, R={R}")
    if S < 1 or P < 1:
        raise ValueError(f"II={S} and n_pes={P} must be positive")
    mem_pes = np.asarray(linked.mem_pes, np.int32).reshape(-1)
    if ((mem_pes < 0) | (mem_pes >= P)).any():
        raise ValueError(f"mem_pes {tuple(mem_pes)} outside [0, {P})")
    layout = pack_tables(linked)
    packed = torch.as_tensor(layout.words).to(device)
    return DeviceTables(linked, device, layout, packed)


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch runs: ``groups`` groups of 32 lanes a block, each
    group's cycle spread over ``warps`` warps; the per-lane state and the
    packed tables each in shared memory or in global memory."""

    groups: int
    warps: int
    state_shared: bool
    tables_shared: bool
    smem_bytes: int

    @property
    def lanes(self) -> int:
        """Lanes a block."""
        return 32 * self.groups

    def blocks(self, B: int) -> int:
        return -(-B // self.lanes)

    @property
    def form(self) -> str:
        return (f"{self.groups}x32 lanes x {self.warps} warps, state "
                f"{'shared' if self.state_shared else 'global'}, tables "
                f"{'shared' if self.tables_shared else 'global'}")


def plan_launch(layout: PackedTables, groups: int = DEFAULT_GROUPS,
                warps: int = DEFAULT_WARPS, *,
                budget: int = SMEM_BUDGET) -> LaunchPlan:
    """The launch of ``layout`` at a geometry of ``groups`` x 32 lanes x
    ``warps`` warps a block, its form chosen from the sizes: the state in
    shared memory if ``groups`` groups' state fits ``budget`` (else as
    many groups as fit, else one group's state in global memory), the
    packed tables beside it if they fit too, else read from global
    memory."""
    if groups < 1 or warps < 1 or 32 * groups * warps > MAX_THREADS:
        raise ValueError(f"geometry {groups}x32 lanes x {warps} warps: "
                         f"at most {MAX_THREADS} threads a block")
    state = 4 * layout.state_rows * 32       # one group's state, bytes
    tables = 4 * layout.words.size
    groups = min(groups, max(1, budget // state))
    state_shared = state * groups <= budget
    used = state * groups if state_shared else 0
    tables_shared = used + tables <= budget
    return LaunchPlan(groups, warps, state_shared, tables_shared,
                      used + (tables if tables_shared else 0))


def _check(tables: DeviceTables, memT: torch.Tensor, n_iters: int
           ) -> Tuple[int, int]:
    if not isinstance(memT, torch.Tensor):
        raise TypeError(f"memT must be a torch.Tensor, got "
                        f"{type(memT).__name__}")
    if memT.dtype != torch.int32 or memT.dim() != 2:
        raise ValueError(f"memT must be a 2-D int32 (M, B) block, got "
                         f"{memT.dtype} {tuple(memT.shape)}")
    if not memT.is_contiguous():
        raise ValueError("memT must be contiguous (lane-minor (M, B))")
    if memT.device != tables.device:
        raise ValueError(f"memT is on {memT.device}, the tables on "
                         f"{tables.device}")
    M, B = memT.shape
    if M < 1 or B < 1:
        raise ValueError(f"empty scratchpad block {tuple(memT.shape)}")
    n = int(n_iters)
    linked = tables.linked
    if n < 0 or linked.t0_max + (n + 1) * linked.II + 2 >= 2 ** 31:
        raise ValueError(f"n_iters={n_iters} out of range")
    return M, B


def cgra_exec(tables: DeviceTables, memT: torch.Tensor, n_iters: int,
              plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Execute ``tables`` for ``n_iters`` iterations over the lane-minor
    (M, B) int32 block ``memT``; returns a new (M, B) block.

    On a CUDA tensor this launches the kernel on the current stream, without
    synchronising, as ``plan`` says (``plan_launch(tables.layout)`` when
    None), or raises; a CPU tensor runs the plain version."""
    global _launches
    M, B = _check(tables, memT, n_iters)
    if memT.device.type == "cpu":
        return cgra_exec_torch(tables.linked, memT, int(n_iters))
    if memT.device.type != "cuda":
        raise ValueError(f"cgra_exec runs on cuda or cpu, not {memT.device}")
    layout = tables.layout
    if plan is None:
        plan = plan_launch(layout)
    out = torch.empty_like(memT)
    scratch = None
    if not plan.state_shared:                # the global-state form only
        scratch = torch.empty((layout.state_rows,
                               plan.blocks(B) * plan.lanes),
                              dtype=torch.int32, device=memT.device)
    fn = _launcher()
    linked = tables.linked
    with torch.cuda.device(memT.device):
        stream = torch.cuda.current_stream(memT.device).cuda_stream
        err = fn(tables.packed.data_ptr(), memT.data_ptr(), out.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 int(layout.words.size), linked.II, layout.n_pes,
                 layout.n_regs, layout.n_fire, layout.n_stage, M, B,
                 linked.total_cycles(int(n_iters)), int(n_iters),
                 plan.groups, plan.warps, int(plan.state_shared),
                 int(plan.tables_shared), plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"cgra_exec launch ({plan.form}, "
                           f"{plan.smem_bytes} bytes of shared memory) "
                           f"failed: CUDA error {err}")
    with _count_lock:
        _launches += 1
    return out


#: fingerprint-keyed memo for callers that pass ``linked=None``: every
#: distinct configuration is lowered at most once per process
_LINKED_MEMO: Dict[str, LinkedConfig] = {}
_LINKED_LOCK = threading.Lock()


def _memoized_link(cfg: MachineConfig) -> LinkedConfig:
    fp = config_fingerprint(cfg)
    with _LINKED_LOCK:
        linked = _LINKED_MEMO.get(fp)
    if linked is None:
        linked = link_config(cfg)
        with _LINKED_LOCK:
            linked = _LINKED_MEMO.setdefault(fp, linked)
    return linked


def cgra_exec_op(cfg: MachineConfig, mem: np.ndarray, n_iters: int, *,
                 device="cuda", lanes: Optional[int] = None,
                 linked: Optional[LinkedConfig] = None) -> np.ndarray:
    """Execute a mapped configuration over (B, M) int32 scratchpad images
    through the persistent engine on ``device`` (the card unless the
    caller asks for ``"cpu"``); returns the final (B, M) images.  ``lanes``
    (the engine's largest launch) defaults to that of the backend for the
    device: ``cuda`` on a card, ``torch`` on the CPU."""
    if linked is None:
        linked = _memoized_link(cfg)
    from repro_torch.ual.backends import get_backend
    from repro_torch.ual.engine import default_engine
    if lanes is None:
        on_card = torch.device(device).type == "cuda"
        lanes = get_backend("cuda" if on_card else "torch").lanes
    out, _ = default_engine().run(linked, np.asarray(mem, np.int32), n_iters,
                                  lanes=lanes, device=device)
    return out
