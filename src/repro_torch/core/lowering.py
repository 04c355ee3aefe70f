"""Shared lowering: resolve a MachineConfig's static routes to dense tables.

This is the single source of truth for the **lowered artifact** every
execution engine consumes.  HyCUBE's central claim is that the
interconnect is *compiler-scheduled*: crossbar settings are static per
II-slot, so a single-cycle multi-hop path is a fixed combinational chain.
We exploit exactly that property — every wire chain is resolved ONCE, at
lowering time, into a direct (source PE, source register) select, so no
engine ever routes dynamically:

  * the vectorized batched simulator (``core.simulator.simulate_batch``)
    turns operand fetch into static numpy gathers over the PE-output /
    register state,
  * the CUDA ``cgra_exec`` kernel and its plain PyTorch version turn it
    into per-lane indexed reads of the same state (the analogue of the
    clockless-repeater bypass).

The ``ual`` compile pipeline runs this as its ``lowering`` pass and
memoizes the result in the mapping cache next to the ``MapResult``,
keyed by the same ``(program.digest, target.digest)`` pair — lower once,
run many.

Lowered operand/source kinds (values in the dense tables):
  K_NONE   = 0 — absent operand
  K_O      = 1 — previous-cycle output latch of PE ``pe``
  K_R      = 2 — register ``reg`` of PE ``pe`` (previous-cycle value)
  K_CONST  = 3 — the instruction immediate
  K_RESULT = 4 — current-cycle ALU result of own PE (register writes only)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core.machine import (MachineConfig, SRC_CONST, SRC_NONE, SRC_REG,
                                      SRC_SELF, XB_IN, XB_NONE, XB_O, XB_REG)

K_NONE, K_O, K_R, K_CONST, K_RESULT = 0, 1, 2, 3, 4

#: bump when the dense-table layout changes — folded into the on-disk
#: cache entry name so stale lowered artifacts are never deserialized
#: (v2: added the ``unresolved_inputs`` lowering-health counter)
LOWERING_VERSION = 2


@dataclass
class LinkedConfig:
    """Dense int32 tables driving every execution engine (the CM image the
    CUDA kernel reads, gather/scatter plans for the batched simulator).
    """
    II: int
    n_pes: int
    n_regs: int
    mem_pes: Tuple[int, ...]
    scalar: np.ndarray    # (S, P, 4)    [opcode, const, use_const, t0]
    ops: np.ndarray       # (S, P, 3, 5) [kind, pe, reg, dist, init]
    regw: np.ndarray      # (S, P, R, 3) [kind, pe, reg]
    #: the fabric's shared-scratchpad port budget, threaded through
    #: unconditionally by ``link_config``.  0 means *unknown/unbounded*:
    #: the engines' runtime oversubscription guard (``limit and
    #: ports_used > limit``) and the static verifier's UAL001 check are
    #: both disabled — port pressure is still *recorded* in ``SimStats``.
    #: Every registered fabric sets a real limit; 0 only appears on
    #: hand-built tables that never saw a fabric.
    n_mem_ports: int = 0
    #: how many wire selects (``SRC_IN`` operands / ``XB_IN`` register
    #: writes) failed to resolve to a driver at lowering time and were
    #: collapsed to a silent ``K_NONE`` row.  0 for every config a
    #: correct mapper emits; the static verifier
    #: (``repro_torch.analysis.verifier``, code UAL004) flags any nonzero
    #: count without re-deriving routing — this is the root exposure of
    #: the silent-``K_NONE`` lowering hazard
    unresolved_inputs: int = 0

    def cm_bytes(self) -> int:
        return self.scalar.nbytes + self.ops.nbytes + self.regw.nbytes

    def __getstate__(self):
        # runtime attachments (the memoized batched-engine plans) must not
        # leak into cache pickles — only the dense tables are the artifact
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    @property
    def t0_max(self) -> int:
        """Latest issue slot in the schedule (static: a table property)."""
        t0 = self.scalar[:, :, 3]
        return int(t0.max()) if (t0 >= 0).any() else 0

    def total_cycles(self, n_iters: int) -> int:
        return self.t0_max + n_iters * self.II + self.II + 2


def lowered_fingerprint(linked: LinkedConfig) -> str:
    """Content hash of the dense tables themselves.

    Identifies a lowered artifact independently of how it was produced —
    the persistent JIT execution engine (``ual.engine``) keys its trace
    cache on it, so two Executables sharing one artifact (same mapping,
    different Program wrappers) also share every compiled trace.  Memoized
    on the instance (underscore attribute: excluded from cache pickles by
    ``LinkedConfig.__getstate__``).
    """
    fp = getattr(linked, "_fingerprint", None)
    if fp is None:
        import hashlib
        h = hashlib.sha256()
        h.update(f"{LOWERING_VERSION}:{linked.II}:{linked.n_pes}:"
                 f"{linked.n_regs}:{linked.mem_pes}:"
                 f"{linked.n_mem_ports}".encode())
        for a in (linked.scalar, linked.ops, linked.regw):
            h.update(np.ascontiguousarray(a).tobytes())
        fp = h.hexdigest()
        linked._fingerprint = fp
    return fp


def config_fingerprint(cfg: MachineConfig) -> str:
    """Content hash of the executable configuration state.

    Identifies WHICH configuration a lowered artifact was derived from:
    the wall-clock-budgeted mapper may legitimately produce different
    configs for the same ``(program, target)`` key on different machines,
    so cached lowered tables are only trusted when their fingerprint
    matches the config in use.
    """
    import hashlib
    h = hashlib.sha256()
    h.update(str(cfg.II).encode())
    for a in (cfg.opcode, cfg.const, cfg.use_const, cfg.t0, cfg.op_src,
              cfg.xbar, cfg.regw):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _resolve_drivers(cfg: MachineConfig, s: int) -> np.ndarray:
    """Per-link ultimate driver for slot ``s``: rows [kind, pe, reg].

    Relaxes the bypass chain the same way the reference simulator does per
    cycle — but once, at lowering time, because the chain is static.
    """
    f = cfg.fabric
    n_links = len(f.links)
    drv = np.zeros((n_links, 3), np.int64)          # K_NONE
    for _ in range(max(1, f.max_hops)):
        changed = False
        for p in range(f.n_pes):
            for j, li in enumerate(f.out_links(p)):
                kind, idx = cfg.xbar[s, p, j]
                if kind == XB_NONE or drv[li, 0] != K_NONE:
                    continue
                if kind == XB_O:
                    drv[li] = (K_O, p, 0)
                    changed = True
                elif kind == XB_REG:
                    drv[li] = (K_R, p, idx)
                    changed = True
                elif kind == XB_IN and drv[idx, 0] != K_NONE:
                    drv[li] = drv[idx]
                    changed = True
        if not changed:
            break
    return drv


def link_config(cfg: MachineConfig) -> LinkedConfig:
    """Lower a MachineConfig to the dense tables the engines execute."""
    S, P = cfg.II, cfg.fabric.n_pes
    R = cfg.regw.shape[2]
    scalar = np.zeros((S, P, 4), np.int32)
    ops = np.zeros((S, P, 3, 5), np.int32)
    regw = np.zeros((S, P, R, 3), np.int32)
    scalar[:, :, 0] = cfg.opcode
    scalar[:, :, 1] = cfg.const
    scalar[:, :, 2] = cfg.use_const
    scalar[:, :, 3] = cfg.t0

    unresolved = 0
    for s in range(S):
        drv = _resolve_drivers(cfg, s)
        for p in range(P):
            for k in range(3):
                kind, idx, dist, init = cfg.op_src[s, p, k]
                if kind == SRC_NONE:
                    row = (K_NONE, 0, 0, dist, init)
                elif kind == SRC_REG:
                    row = (K_R, p, idx, dist, init)
                elif kind == SRC_SELF:
                    row = (K_O, p, 0, dist, init)
                elif kind == SRC_CONST:
                    row = (K_CONST, 0, 0, dist, init)
                else:                                  # SRC_IN: wire -> driver
                    dk, dp, dr = drv[idx]
                    if dk == K_NONE:
                        # the driver fixed point never resolved: the
                        # operand collapses to an absent source.  Count
                        # it so the verifier / fingerprint consumers can
                        # flag the hazard without re-deriving routing
                        unresolved += 1
                    row = (int(dk), int(dp), int(dr), dist, init)
                ops[s, p, k] = row
            for r in range(R):
                kind, idx = cfg.regw[s, p, r]
                if kind == XB_NONE:
                    regw[s, p, r] = (K_NONE, 0, 0)
                elif kind == XB_O:
                    regw[s, p, r] = (K_RESULT, p, 0)
                else:                                  # XB_IN via wire
                    dk, dp, dr = drv[idx]
                    if dk == K_NONE:
                        unresolved += 1
                    regw[s, p, r] = (int(dk), int(dp), int(dr))
    return LinkedConfig(II=cfg.II, n_pes=P, n_regs=R,
                        mem_pes=tuple(cfg.fabric.mem_pes),
                        scalar=scalar, ops=ops, regw=regw,
                        n_mem_ports=cfg.fabric.n_mem_ports,
                        unresolved_inputs=unresolved)
