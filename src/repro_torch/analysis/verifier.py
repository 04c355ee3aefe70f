"""Compile-time CGRA configuration verifier — static diagnostics.

Morpher pairs compilation with *validation*: a mapped configuration is
only trusted once checked.  Runtime validation (the DFG-interpreter
oracle) proves value-level correctness, but several hazard classes are
decidable **statically** over the modulo schedule — the schedule is
periodic, the interconnect is compiler-scheduled, and the dense lowered
tables (``core.lowering.LinkedConfig``) expose every operand source
directly.  This pass walks a ``MachineConfig`` + ``LinkedConfig`` (+ the
``Program`` I/O spec when available) and emits structured diagnostics
*before* a single cycle is simulated, so a broken config fails
``ual.compile()`` instead of surfacing deep inside the batched simulator
or the CUDA engine (or worse: silently, as an operand reading absent).

Diagnostic codes (stable — see ``docs/diagnostics.md`` for the full
reference table):

  ======== ======== ====================================================
  code     severity meaning
  ======== ======== ====================================================
  UAL001   error    scratchpad port oversubscription in one II slot
  UAL002   error    same-cycle write-write race (constant-foldable
                    scratchpad addresses)
  UAL003   warning  same-cycle load/store overlap at one constant
                    address (PE-order dependent value)
  UAL004   error    unresolved wire chain: a ``SRC_IN`` operand select
                    (or wire-fed register write) whose driver fixed
                    point never resolves — lowers to a silent ``K_NONE``
  UAL005   error    bypass chain longer than ``fabric.max_hops``
  UAL006   warning  use-before-def: register read never written in any
                    schedule slot (reads as constant 0)
  UAL007   warning  dead code: an instruction's result is consumed by
                    nothing (no operand, no register write, no store)
  UAL008   error    table integrity: out-of-range PE/register index or
                    illegal source kind in the dense tables
  UAL009   error    schedule inconsistency: an instruction's ``t0`` is
                    not congruent to its slot modulo II / negative
                    recurrence distance
  UAL010   error    memory op placed on a PE without scratchpad access
  UAL011   info     memory-port budget unknown (``n_mem_ports == 0``) —
                    the oversubscription check is disabled
  UAL012   error    constant-foldable scratchpad address out of bounds
                    for the program's data layout
  ======== ======== ====================================================

The verifier is pure analysis: it never mutates its inputs and never
lowers when handed a pre-lowered artifact (the pipeline's ``verify``
pass reuses the lowering pass's output, so verification adds zero
re-lowering).  Handed *only* a ``LinkedConfig`` (tables shipped across
processes without the source config), the wire-level detectors fall back
to the ``LinkedConfig.unresolved_inputs`` counter stamped at lowering
time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig, link_config)
from repro_torch.core.machine import (OPC, OPCODES, SRC_IN, MachineConfig, XB_IN,
                                      XB_NONE, XB_O, XB_REG)

ERROR, WARNING, INFO = "error", "warning", "info"

#: code -> (default severity, one-line meaning) — the stable registry;
#: ``docs/diagnostics.md`` renders this table for humans
CODES: Dict[str, Tuple[str, str]] = {
    "UAL001": (ERROR, "scratchpad port oversubscription in one II slot"),
    "UAL002": (ERROR, "same-cycle write-write race at one scratchpad "
                      "address"),
    "UAL003": (WARNING, "same-cycle load/store overlap at one scratchpad "
                        "address"),
    "UAL004": (ERROR, "unresolved wire chain (operand lowers to a silent "
                      "K_NONE)"),
    "UAL005": (ERROR, "bypass chain exceeds fabric.max_hops"),
    "UAL006": (WARNING, "use-before-def: register read never written"),
    "UAL007": (WARNING, "dead code: instruction result consumed by "
                        "nothing"),
    "UAL008": (ERROR, "table integrity: out-of-range index or illegal "
                      "source kind"),
    "UAL009": (ERROR, "schedule inconsistency (t0 vs slot, negative "
                      "dist)"),
    "UAL010": (ERROR, "memory op on a PE without scratchpad access"),
    "UAL011": (INFO, "memory-port budget unknown; port check disabled"),
    "UAL012": (ERROR, "constant scratchpad address out of bounds"),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, severity, locus and rendering."""

    code: str
    severity: str
    message: str
    slot: Optional[int] = None       # II slot, when the finding has one
    pe: Optional[int] = None         # PE index, when the finding has one

    @property
    def locus(self) -> str:
        parts = []
        if self.slot is not None:
            parts.append(f"slot {self.slot}")
        if self.pe is not None:
            parts.append(f"pe {self.pe}")
        return "/".join(parts)

    def render(self) -> str:
        at = f" [{self.locus}]" if self.locus else ""
        return f"{self.code} {self.severity}{at}: {self.message}"

    def __str__(self) -> str:
        return self.render()


@dataclass
class CheckReport:
    """The collected diagnostics of one verification run."""

    name: str = ""                   # "program @ fabric", for rendering
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == INFO]

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings/infos don't fail)."""
        return not self.errors

    def codes(self) -> Set[str]:
        return {d.code for d in self.diagnostics}

    def counts(self) -> Dict[str, int]:
        return {"errors": len(self.errors), "warnings": len(self.warnings),
                "infos": len(self.infos)}

    def summary(self) -> str:
        c = self.counts()
        if not self.diagnostics:
            return "clean (0 findings)"
        return (f"{c['errors']} error(s), {c['warnings']} warning(s), "
                f"{c['infos']} info(s): {', '.join(sorted(self.codes()))}")

    def render(self) -> str:
        head = f"verify {self.name}: " if self.name else "verify: "
        lines = [head + self.summary()]
        lines += ["  " + d.render() for d in self.diagnostics]
        return "\n".join(lines)

    def to_json(self) -> Dict[str, object]:
        return {"name": self.name, "ok": self.ok, **self.counts(),
                "codes": sorted(self.codes()),
                "diagnostics": [{"code": d.code, "severity": d.severity,
                                 "slot": d.slot, "pe": d.pe,
                                 "message": d.message}
                                for d in self.diagnostics]}

    def __str__(self) -> str:
        return self.render()


class VerifyError(RuntimeError):
    """A configuration failed static verification (error-severity
    findings).  Carries the full ``CheckReport`` as ``.report``; the
    exception message is the rendered report."""

    def __init__(self, report: CheckReport):
        super().__init__(report.render())
        self.report = report


# ---------------------------------------------------------------------------
# Detectors over the dense lowered tables
# ---------------------------------------------------------------------------

_MEM_OPC = (OPC["LOAD"], OPC["STORE"])


def _fires(linked: LinkedConfig, s: int, p: int) -> bool:
    """Whether the instruction at (slot, pe) can ever fire."""
    return (linked.scalar[s, p, 0] != OPC["NOP"]
            and linked.scalar[s, p, 3] >= 0)


def _check_integrity(linked: LinkedConfig, out: List[Diagnostic]) -> None:
    """UAL008 (index/kind range) + UAL009 (schedule consistency)."""
    S, P, R = linked.II, linked.n_pes, linked.n_regs
    ops_kinds = {K_NONE, K_O, K_R, K_CONST}
    regw_kinds = {K_NONE, K_O, K_R, K_RESULT}
    for s in range(S):
        for p in range(P):
            opc = int(linked.scalar[s, p, 0])
            t0 = int(linked.scalar[s, p, 3])
            if not 0 <= opc < len(OPCODES):
                out.append(Diagnostic("UAL008", ERROR,
                                      f"opcode {opc} out of range "
                                      f"[0, {len(OPCODES)})", s, p))
                continue
            if opc != OPC["NOP"] and t0 >= 0 and t0 % S != s:
                out.append(Diagnostic(
                    "UAL009", ERROR,
                    f"{OPCODES[opc]} has t0={t0} but t0 % II = "
                    f"{t0 % S} != slot {s}", s, p))
            for k in range(3):
                kind, pe, reg, dist = (int(v) for v in
                                       linked.ops[s, p, k, :4])
                if kind not in ops_kinds:
                    out.append(Diagnostic(
                        "UAL008", ERROR,
                        f"operand {k} has illegal source kind {kind}"
                        + (" (K_RESULT is regw-only)"
                           if kind == K_RESULT else ""), s, p))
                    continue
                if kind in (K_O, K_R) and not 0 <= pe < P:
                    out.append(Diagnostic(
                        "UAL008", ERROR,
                        f"operand {k} reads PE {pe}, fabric has {P}",
                        s, p))
                if kind == K_R and not 0 <= reg < R:
                    out.append(Diagnostic(
                        "UAL008", ERROR,
                        f"operand {k} reads register {reg}, PEs have "
                        f"{R}", s, p))
                if dist < 0:
                    out.append(Diagnostic(
                        "UAL009", ERROR,
                        f"operand {k} has negative recurrence distance "
                        f"{dist}", s, p))
            for r in range(R):
                kind, pe, reg = (int(v) for v in linked.regw[s, p, r])
                if kind not in regw_kinds:
                    out.append(Diagnostic(
                        "UAL008", ERROR,
                        f"register write r{r} has illegal source kind "
                        f"{kind}", s, p))
                    continue
                if kind in (K_O, K_R, K_RESULT) and not 0 <= pe < P:
                    out.append(Diagnostic(
                        "UAL008", ERROR,
                        f"register write r{r} reads PE {pe}, fabric "
                        f"has {P}", s, p))
                if kind == K_R and not 0 <= reg < R:
                    out.append(Diagnostic(
                        "UAL008", ERROR,
                        f"register write r{r} reads register {reg}, "
                        f"PEs have {R}", s, p))


def _check_ports(linked: LinkedConfig, out: List[Diagnostic]) -> None:
    """UAL001 (static per-slot port pressure) + UAL011 (unknown budget).

    Instructions sharing an II slot fire in the same cycles once every
    firing window has opened (the schedule is periodic), so the per-slot
    memory-op count IS the steady-state port pressure — what the engines
    otherwise only discover mid-run via ``check_ports``.
    """
    limit = linked.n_mem_ports
    if limit <= 0:
        out.append(Diagnostic(
            "UAL011", INFO,
            "n_mem_ports=0 (unknown/unbounded): port oversubscription "
            "is not statically checkable and the engines' runtime "
            "check is disabled"))
        return
    for s in range(linked.II):
        mem_pes = [p for p in range(linked.n_pes)
                   if int(linked.scalar[s, p, 0]) in _MEM_OPC
                   and _fires(linked, s, p)]
        if len(mem_pes) > limit:
            out.append(Diagnostic(
                "UAL001", ERROR,
                f"{len(mem_pes)} memory ops on PEs {mem_pes} share "
                f"slot {s}, scratchpad has {limit} port(s)", s))


def _check_mem_pes(linked: LinkedConfig, out: List[Diagnostic]) -> None:
    """UAL010: LOAD/STORE on a PE without LSU access."""
    mem_set = set(linked.mem_pes)
    for s in range(linked.II):
        for p in range(linked.n_pes):
            opc = int(linked.scalar[s, p, 0])
            if (opc in _MEM_OPC and _fires(linked, s, p)
                    and p not in mem_set):
                out.append(Diagnostic(
                    "UAL010", ERROR,
                    f"{OPCODES[opc]} on PE {p}, which has no scratchpad "
                    f"access (mem PEs: {sorted(mem_set)})", s, p))


def _const_addr_mem_ops(linked: LinkedConfig, s: int
                        ) -> List[Tuple[int, bool, int]]:
    """Constant-foldable memory ops of one slot: (pe, is_load, addr).

    A LOAD with no index operand reads ``const``; a STORE with no second
    operand writes ``const`` — both decidable without executing.
    """
    ops = []
    for p in range(linked.n_pes):
        if not _fires(linked, s, p):
            continue
        opc = int(linked.scalar[s, p, 0])
        const = int(linked.scalar[s, p, 1])
        if opc == OPC["LOAD"] and linked.ops[s, p, 0, 0] == K_NONE:
            ops.append((p, True, const))
        elif opc == OPC["STORE"] and linked.ops[s, p, 1, 0] == K_NONE:
            ops.append((p, False, const))
    return ops


def _check_mem_conflicts(linked: LinkedConfig, out: List[Diagnostic],
                         total_words: Optional[int]) -> None:
    """UAL002 (write-write), UAL003 (load/store overlap), UAL012 (bounds).

    Same-(pe, register) write-write races are structurally unrepresentable
    in the dense tables (one ``regw`` row per destination — ``emit_config``
    raises on collision), so the same-cycle race surface that remains is
    the shared scratchpad at constant-foldable addresses.
    """
    for s in range(linked.II):
        const_ops = _const_addr_mem_ops(linked, s)
        by_addr: Dict[int, List[Tuple[int, bool]]] = {}
        for p, is_load, addr in const_ops:
            by_addr.setdefault(addr, []).append((p, is_load))
            if total_words is not None and not 0 <= addr < total_words:
                out.append(Diagnostic(
                    "UAL012", ERROR,
                    f"{'LOAD' if is_load else 'STORE'} at constant "
                    f"address {addr}, scratchpad has {total_words} "
                    f"words", s, p))
        for addr, users in by_addr.items():
            writers = [p for p, is_load in users if not is_load]
            readers = [p for p, is_load in users if is_load]
            if len(writers) > 1:
                out.append(Diagnostic(
                    "UAL002", ERROR,
                    f"PEs {writers} all store to address {addr} in the "
                    f"same cycle (write-write race)", s))
            if writers and readers:
                out.append(Diagnostic(
                    "UAL003", WARNING,
                    f"PE {readers} load address {addr} in the same "
                    f"cycle PE {writers} store it (value depends on "
                    f"PE order)", s))


def _check_liveness(linked: LinkedConfig, out: List[Diagnostic]) -> None:
    """UAL006 (use-before-def) + UAL007 (dead code).

    Consumption is aggregated per PE output latch / per register across
    the whole schedule (every wrap), so a value produced in one slot and
    consumed in another is live.  The dead-code check is one-level (a
    result feeding only a never-read register still counts as consumed)
    and conservative per PE, so it never flags a live multi-slot chain.
    """
    S, P, R = linked.II, linked.n_pes, linked.n_regs
    consumed_o: Set[int] = set()           # PEs whose O latch/result is read
    read_regs: Set[Tuple[int, int]] = set()
    written_regs: Set[Tuple[int, int]] = set()
    read_locus: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for s in range(S):
        for p in range(P):
            if _fires(linked, s, p):
                for k in range(3):
                    kind, pe, reg = (int(v) for v in
                                     linked.ops[s, p, k, :3])
                    if kind == K_O and 0 <= pe < P:
                        consumed_o.add(pe)
                    elif kind == K_R and 0 <= pe < P and 0 <= reg < R:
                        read_regs.add((pe, reg))
                        read_locus.setdefault((pe, reg), (s, p))
            for r in range(R):
                kind, pe, reg = (int(v) for v in linked.regw[s, p, r])
                written = kind != K_NONE
                if written:
                    written_regs.add((p, r))
                if kind in (K_O, K_RESULT) and 0 <= pe < P:
                    consumed_o.add(pe)
                elif kind == K_R and 0 <= pe < P and 0 <= reg < R:
                    read_regs.add((pe, reg))
                    read_locus.setdefault((pe, reg), (s, p))
    for pe, reg in sorted(read_regs - written_regs):
        s, p = read_locus[(pe, reg)]
        out.append(Diagnostic(
            "UAL006", WARNING,
            f"register r{reg} of PE {pe} is read but never written in "
            f"any slot (reads as constant 0)", s, p))
    side_effect = {OPC["NOP"], OPC["STORE"]}
    for s in range(S):
        for p in range(P):
            opc = int(linked.scalar[s, p, 0])
            if (opc not in side_effect and _fires(linked, s, p)
                    and p not in consumed_o):
                out.append(Diagnostic(
                    "UAL007", WARNING,
                    f"{OPCODES[opc]} result is consumed by nothing (no "
                    f"operand, no register write, no store)", s, p))


# ---------------------------------------------------------------------------
# Wire-level detectors over the raw MachineConfig
# ---------------------------------------------------------------------------

def _resolve_depths(cfg: MachineConfig, s: int) -> np.ndarray:
    """Per-link bypass-chain depth for slot ``s`` (-1 = never resolves).

    Unlike ``core.lowering._resolve_drivers`` this relaxes to a full
    fixed point (not ``max_hops`` rounds), so a chain that *would*
    resolve given more hops is distinguishable from one that never
    resolves at all (undriven or cyclic).
    """
    f = cfg.fabric
    n_links = len(f.links)
    depth = np.full(n_links, -1, np.int64)
    for _ in range(n_links + 1):
        changed = False
        for p in range(f.n_pes):
            for j, li in enumerate(f.out_links(p)):
                kind, idx = (int(v) for v in cfg.xbar[s, p, j])
                if kind == XB_NONE or depth[li] >= 0:
                    continue
                if kind in (XB_O, XB_REG):
                    depth[li] = 1
                    changed = True
                elif (kind == XB_IN and 0 <= idx < n_links
                        and depth[idx] >= 0):
                    depth[li] = depth[idx] + 1
                    changed = True
        if not changed:
            break
    return depth


def _check_wires(cfg: MachineConfig, out: List[Diagnostic]) -> None:
    """UAL004 (unresolved/cyclic chains) + UAL005 (hop-budget excess).

    These need the raw config: the lowered tables have already collapsed
    every chain (an unresolved one into a silent ``K_NONE``), so only
    the crossbar settings can say *why* a select failed to resolve.
    """
    f = cfg.fabric
    n_links = len(f.links)
    for s in range(cfg.II):
        depth = _resolve_depths(cfg, s)

        def flag(li: int, what: str, p: int) -> None:
            if not 0 <= li < n_links:
                out.append(Diagnostic(
                    "UAL008", ERROR,
                    f"{what} selects link {li}, fabric has {n_links}",
                    s, p))
            elif depth[li] < 0:
                out.append(Diagnostic(
                    "UAL004", ERROR,
                    f"{what} reads link {li}, whose driver chain never "
                    f"resolves (undriven or cyclic) — it would lower "
                    f"to a silent K_NONE", s, p))
            elif depth[li] > f.max_hops:
                out.append(Diagnostic(
                    "UAL005", ERROR,
                    f"{what} reads link {li} through a {depth[li]}-hop "
                    f"bypass chain; fabric allows {f.max_hops} "
                    f"hop(s)/cycle", s, p))

        for p in range(f.n_pes):
            for k in range(3):
                kind, idx = int(cfg.op_src[s, p, k, 0]), \
                    int(cfg.op_src[s, p, k, 1])
                if kind == SRC_IN:
                    flag(idx, f"operand {k}", p)
            for r in range(cfg.regw.shape[2]):
                kind, idx = (int(v) for v in cfg.regw[s, p, r])
                if kind == XB_IN:
                    flag(idx, f"register write r{r}", p)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def verify(cfg: Optional[MachineConfig] = None,
           linked: Optional[LinkedConfig] = None,
           program=None, name: str = "") -> CheckReport:
    """Statically verify a mapped configuration; returns a ``CheckReport``.

    ``cfg``     — the raw machine configuration (enables the wire-level
                  detectors UAL004/UAL005 with exact loci),
    ``linked``  — the lowered artifact (never re-lowered when given; if
                  omitted and ``cfg`` is present, it is lowered here),
    ``program`` — anything with ``.layout.total_words`` (the UAL
                  ``Program``), enabling the address-bounds check UAL012.

    At least one of ``cfg``/``linked`` is required.  The report's ``ok``
    is True iff no error-severity findings; use ``raise_if_errors`` (or
    the pipeline's ``verify`` pass) to turn errors into ``VerifyError``.
    """
    if cfg is None and linked is None:
        raise ValueError("verify() needs a MachineConfig, a LinkedConfig, "
                         "or both")
    if linked is None:
        linked = link_config(cfg)
    diags: List[Diagnostic] = []
    _check_integrity(linked, diags)
    _check_ports(linked, diags)
    _check_mem_pes(linked, diags)
    total_words = None
    if program is not None:
        layout = getattr(program, "layout", None)
        total_words = getattr(layout, "total_words", None)
    _check_mem_conflicts(linked, diags, total_words)
    _check_liveness(linked, diags)
    if cfg is not None:
        _check_wires(cfg, diags)
    elif linked.unresolved_inputs:
        # tables shipped without their source config: the lowering-time
        # counter is the only witness of the silent-K_NONE collapses
        diags.append(Diagnostic(
            "UAL004", ERROR,
            f"{linked.unresolved_inputs} wire select(s) failed to "
            f"resolve at lowering time (collapsed to K_NONE); re-verify "
            f"with the source MachineConfig for exact loci"))
    return CheckReport(name=name, diagnostics=diags)


def raise_if_errors(report: CheckReport) -> CheckReport:
    """Raise ``VerifyError`` if the report has error-severity findings;
    returns the report unchanged otherwise (chainable)."""
    if not report.ok:
        raise VerifyError(report)
    return report
