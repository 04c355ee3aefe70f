"""The staged compile pipeline behind ``ual.compile``.

``compile()`` used to be one opaque function; it is now a sequence of
instrumented passes, each timed with ``time.perf_counter`` and reporting a
``PassRecord(name, wall_s, stats)`` into ``CompileInfo.passes``:

  * ``layout``   — fold the planned scratchpad layout into the DFG
    (base addresses into LOAD/STOREs),
  * ``mii``      — Rau's iterative-modulo-scheduling lower bounds
    (ResMII / RecMII),
  * ``mapping``  — cache lookup, then the registered ``MapperStrategy``
    for temporal fabrics / the analytic ``spatial_ii`` model for spatial
    ones; mapping-free backends skip this pass,
  * ``lowering`` — lower the mapped configuration once to the dense
    linked tables (``core.lowering.LinkedConfig``) every execution
    engine consumes; memoized in the cache next to the ``MapResult``
    under the same digest key, so a warm compile re-lowers nothing,
  * ``verify``   — the static diagnostics pass
    (``repro_torch.analysis.verifier``): port oversubscription, write-write
    races, unresolved wire chains, use-before-def / dead code, table
    integrity — decidable over the modulo schedule without running a
    cycle.  Error-severity findings fail the compile with a rendered
    ``VerifyError``; warnings/infos ride along in the pass record and
    on ``Executable.check_report``,
  * ``binding``  — bind the execution backend and record whether the
    result is runnable / validatable.

The pass list is data, not control flow: tooling can build a custom
``Pipeline`` (extra analysis passes, alternative mapping passes) and hand
it to ``compile(..., pipeline=...)`` without forking the compiler.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.verifier import CheckReport, VerifyError, verify
from repro_torch.core.lowering import (LinkedConfig, config_fingerprint,
                                       link_config)
from repro_torch.core.mapper import (MapResult, map_dfg, rec_mii, res_mii,
                                     spatial_ii)
from repro_torch.ual.backends import Backend
from repro_torch.ual.cache import MappingCache, default_cache
from repro_torch.ual.executable import PassRecord
from repro_torch.ual.program import Program
from repro_torch.ual.target import Target


@dataclass
class CompileContext:
    """Mutable state threaded through the passes of one compile."""

    program: Program
    target: Target
    cache: Optional[MappingCache] = None
    use_cache: bool = True
    backend: Optional[Backend] = None
    # -- filled in by passes --------------------------------------------------
    rec: Optional[int] = None            # RecMII
    res: Optional[int] = None            # ResMII
    mii: Optional[int] = None
    result: Optional[MapResult] = None   # None for mapping-free backends
    lowered: Optional[LinkedConfig] = None  # the lowered artifact
    spatial_subgraphs: int = 0
    cache_hit: bool = False
    restarts_paid: int = 0               # mapper restarts paid by THIS compile
    key: Optional[Tuple[str, str]] = None
    #: the per-key compile lock, HELD, when this compile is the cold
    #: winner for its key: acquired by the mapping pass before mapping,
    #: kept through the lowering pass (so racing threads wait for the
    #: whole mapping+lowering, paying exactly one of each), released by
    #: ``Pipeline.run``'s finally
    key_lock: Optional[object] = None
    #: the cross-PROCESS analogue (``MappingCache.process_lock_key``):
    #: an fcntl file lock HELD by the cold winner alongside ``key_lock``
    #: so racing *processes* sharing the disk cache also pay exactly one
    #: mapping + one lowering per key; released by ``Pipeline.run``
    process_lock: Optional[object] = None
    check_report: Optional[CheckReport] = None  # the verify pass's findings
    records: List[PassRecord] = field(default_factory=list)


class CompilePass:
    """One pipeline stage: mutate the context, return stats to report."""

    name: str = "?"

    def run(self, ctx: CompileContext) -> Optional[Dict[str, object]]:
        raise NotImplementedError


class LayoutPass(CompilePass):
    """Apply the planned scratchpad layout (``Program.laid``)."""

    name = "layout"

    def run(self, ctx):
        laid = ctx.program.laid
        return {"n_nodes": len(laid.nodes),
                "n_arrays": len(ctx.program.arrays),
                "n_banks": ctx.program.layout.n_banks}


class MIIBoundsPass(CompilePass):
    """Rau's lower bounds: RecMII always, ResMII for temporal fabrics."""

    name = "mii"

    def run(self, ctx):
        laid, fabric = ctx.program.laid, ctx.target.fabric
        ctx.rec = rec_mii(laid)
        ctx.res = res_mii(laid, fabric)
        ctx.mii = max(ctx.rec, ctx.res)
        return {"rec_mii": ctx.rec, "res_mii": ctx.res, "mii": ctx.mii}


class MappingPass(CompilePass):
    """Cache lookup + strategy dispatch (the expensive pass).

    Temporal fabrics resolve ``target.strategy`` through the mapper
    strategy registry; spatial fabrics use the analytic ``spatial_ii``
    model; mapping-free backends (``interp``) skip mapping entirely.
    Results are memoized per ``(program.digest, target.digest)`` —
    failures only in-process (``memory_only``): the time budget makes
    failure wall-clock dependent, so a failure observed on a loaded
    machine must never be pinned on disk for other processes to inherit.
    """

    name = "mapping"

    def run(self, ctx):
        target = ctx.target
        if not target.fabric.temporal:
            ii, n_parts = spatial_ii(ctx.program.laid, target.fabric)
            ctx.result = MapResult(True, ii, ctx.rec, strategy="spatial")
            ctx.spatial_subgraphs = n_parts
            return {"model": "spatial_ii", "II": ii, "subgraphs": n_parts}
        if ctx.backend is not None and not ctx.backend.requires_config:
            return {"skipped": "mapping-free backend"}

        key = (ctx.program.digest, target.digest)
        ctx.key = key

        def _map() -> MapResult:
            return map_dfg(ctx.program.laid, target.fabric,
                           ii_max=target.ii_max, seed=target.seed,
                           strategy=target.strategy,
                           max_restarts=target.max_restarts,
                           label_fn=target.label_fn,
                           time_budget_s=target.time_budget_s)

        # targets carrying a label_fn always compile cold: the hook is
        # unhashable, so caching it would serve stale placements
        cacheable = ctx.use_cache and target.label_fn is None
        if not cacheable:
            result = _map()
            ctx.restarts_paid = result.restarts
            ctx.result = result
            return {"cache": "bypass", "strategy": result.strategy,
                    "II": result.II, "restarts": result.restarts,
                    "success": result.success}
        c = ctx.cache if ctx.cache is not None else default_cache()
        result = c.get(key)
        if result is not None:
            ctx.result = result
            ctx.cache_hit = True
            return {"cache": "hit", "strategy": result.strategy,
                    "II": result.II, "success": result.success}
        # double-checked under the per-key lock: if another thread is
        # compiling this very key right now, wait for its result instead
        # of paying a second mapper run (uncounted peek — a hit here is
        # an in-flight compile finishing, not a warm cache).  The cold
        # winner KEEPS the lock through the lowering pass, so racers also
        # wait out the lowering — one mapper run AND one lowering per key
        lock = c.lock_key(key)
        lock.acquire()
        ctx.key_lock = lock              # released by Pipeline.run
        result = c.peek(key)
        if result is not None:
            ctx.key_lock = None
            lock.release()
            ctx.result = result
            ctx.cache_hit = True
            return {"cache": "hit", "inflight": True,
                    "strategy": result.strategy, "II": result.II,
                    "success": result.success}
        # still cold in this process: take the cross-process file lock
        # too (None for diskless caches) and peek once more — another
        # PROCESS may have just published the entry to the shared disk
        # dir while we waited.  Held through lowering like key_lock, so
        # a cold tenant pays one mapping + one lowering cluster-wide.
        plock = c.process_lock_key(key)
        if plock is not None:
            plock.acquire()
            ctx.process_lock = plock     # released by Pipeline.run
            result = c.peek(key)
            if result is not None:
                ctx.process_lock = ctx.key_lock = None
                plock.release()
                lock.release()
                ctx.result = result
                ctx.cache_hit = True
                return {"cache": "hit", "inflight": True,
                        "cross_process": True,
                        "strategy": result.strategy, "II": result.II,
                        "success": result.success}
        result = _map()
        ctx.restarts_paid = result.restarts
        c.put(key, result, memory_only=not result.success)
        ctx.result = result
        return {"cache": "miss", "strategy": result.strategy,
                "II": result.II, "restarts": result.restarts,
                "success": result.success}


class LoweringPass(CompilePass):
    """Lower the mapped configuration once to the dense linked tables.

    The lowered artifact (``core.lowering.LinkedConfig``) is what every
    execution engine consumes — the vectorized batched simulator gathers
    over it, the CUDA kernel keeps it resident on the card.  It is a
    pure function of the machine configuration, so it is memoized in the
    cache next to the ``MapResult`` under the same
    ``(program.digest, target.digest)`` key: a warm compile reuses the
    cached tables with zero re-lowering.  Skipped when there is nothing
    to lower (mapping-free backends, spatial fabrics, failed mappings).
    """

    name = "lowering"

    def run(self, ctx):
        r = ctx.result
        if r is None or not r.success or r.config is None:
            return {"skipped": "no machine configuration"}
        cacheable = (ctx.use_cache and ctx.target.label_fn is None
                     and ctx.key is not None)
        # the fingerprint pins the tables to THIS configuration: the
        # budgeted mapper may produce a different config for the same key
        # (re-map after a lost mapping pickle, racing processes sharing
        # the disk dir), and stale tables must read as a miss
        fp = config_fingerprint(r.config)
        if not cacheable:
            ctx.lowered = link_config(r.config)
            return {"cache": "bypass", "cm_bytes": ctx.lowered.cm_bytes()}
        c = ctx.cache if ctx.cache is not None else default_cache()
        if ctx.key_lock is not None:
            # cold-compile winner: we still hold the key lock from the
            # mapping pass, so nobody else can be lowering this key
            lowered = c.get_lowered(ctx.key, fp)
            if lowered is None:
                lowered = link_config(r.config)
                c.put_lowered(ctx.key, lowered, fp)
                ctx.lowered = lowered
                return {"cache": "miss", "cm_bytes": lowered.cm_bytes()}
            ctx.lowered = lowered
            return {"cache": "hit", "cm_bytes": lowered.cm_bytes()}
        lowered = c.get_lowered(ctx.key, fp)
        if lowered is not None:
            ctx.lowered = lowered
            return {"cache": "hit", "cm_bytes": lowered.cm_bytes()}
        # mapping was warm but the tables are not (fingerprint mismatch,
        # lost lowered pickle): double-check under the per-key lock so
        # concurrent re-lowerings still collapse to one
        with c.lock_key(ctx.key):
            lowered = c.peek_lowered(ctx.key, fp)
            if lowered is not None:
                ctx.lowered = lowered
                return {"cache": "hit", "inflight": True,
                        "cm_bytes": lowered.cm_bytes()}
            lowered = link_config(r.config)
            c.put_lowered(ctx.key, lowered, fp)
        ctx.lowered = lowered
        return {"cache": "miss", "cm_bytes": lowered.cm_bytes()}


class VerifyPass(CompilePass):
    """Static diagnostics over the mapped config + lowered artifact.

    Runs the compile-time verifier (``repro_torch.analysis.verifier``) on
    every compile that produced a machine configuration — including
    cache-warm ones, so corrupted cached tables are caught too.  Reuses
    the lowering pass's artifact (zero re-lowering; the exactly-one-
    lowering contract holds).  In ``strict`` mode (the default
    pipeline), error-severity findings abort the compile by raising
    ``VerifyError`` with the rendered report; warnings and infos are
    recorded in the pass stats and surfaced on
    ``Executable.check_report``.  ``strict=False`` (the
    ``repro_torch.ual.check`` CLI) always collects the full report.
    """

    name = "verify"

    def __init__(self, strict: bool = True):
        self.strict = strict

    def run(self, ctx):
        r = ctx.result
        if r is None or not r.success or r.config is None:
            return {"skipped": "no machine configuration"}
        report = verify(cfg=r.config, linked=ctx.lowered,
                        program=ctx.program,
                        name=f"{ctx.program.name} @ "
                             f"{ctx.target.fabric.name}")
        ctx.check_report = report
        if self.strict and not report.ok:
            raise VerifyError(report)
        return {**report.counts(), "ok": report.ok,
                "codes": sorted(report.codes())}


class BindingPass(CompilePass):
    """Validation binding: tie the backend to the mapping artifacts.

    Records whether the executable can actually run (a config exists when
    the backend needs one) and whether ``validate()`` has an oracle path —
    surfacing at compile time what would otherwise only show up as a
    ``RuntimeError`` at ``run()`` time.
    """

    name = "binding"

    def run(self, ctx):
        be, r = ctx.backend, ctx.result
        needs = be.requires_config if be is not None else True
        runnable = (not needs) or (r is not None and r.success
                                   and r.config is not None)
        return {"backend": ctx.target.backend, "requires_config": needs,
                "runnable": runnable,
                "validatable": runnable and ctx.target.backend != "interp"}


@dataclass
class Pipeline:
    """An ordered pass list; ``run`` times each pass into the context."""

    passes: List[CompilePass]

    def run(self, ctx: CompileContext) -> CompileContext:
        from repro_torch import obs
        tr = obs.tracer()
        try:
            for p in self.passes:
                t0 = time.perf_counter()
                stats = p.run(ctx)
                t1 = time.perf_counter()
                ctx.records.append(PassRecord(p.name, t1 - t0, stats or {}))
                if tr.enabled:
                    # one span per pass, same wall-times as the
                    # PassRecord; nests under compile()'s root span
                    tr.record(f"pass:{p.name}", t0, t1, cat="compile",
                              args=stats or None)
        finally:
            # the cold winner's per-key compile locks (see CompileContext
            # .key_lock / .process_lock) are released here even when a
            # pass raises or a custom pipeline omits the lowering pass
            if ctx.process_lock is not None:
                plock, ctx.process_lock = ctx.process_lock, None
                plock.release()
            if ctx.key_lock is not None:
                lock, ctx.key_lock = ctx.key_lock, None
                lock.release()
        return ctx


def default_pipeline(strict_verify: bool = True) -> Pipeline:
    """The standard pass list.  ``strict_verify=False`` keeps the verify
    pass but collects error findings into ``Executable.check_report``
    instead of raising — what the ``repro_torch.ual.check`` CLI uses to render
    complete reports for broken configs."""
    return Pipeline([LayoutPass(), MIIBoundsPass(), MappingPass(),
                     LoweringPass(), VerifyPass(strict=strict_verify),
                     BindingPass()])
