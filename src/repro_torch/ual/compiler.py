"""``compile(program, target) -> Executable`` — the toolchain entry point.

One call replaces the hand-wired seven-step ritual
(``DFGBuilder -> plan_layout -> apply_layout -> map_dfg -> flat_memory ->
simulate -> unflatten_memory``) every consumer used to repeat.  It drives
the staged pass pipeline in ``ual.pipeline``
(layout -> MII bounds -> mapping strategy -> lowering -> validation
binding), so:

  * temporal fabrics go through a registered ``MapperStrategy``
    (``adaptive``/``sa`` built-in, ``ual.register_strategy`` to extend),
    memoized in the mapping cache keyed on
    ``(program.digest, target.digest)`` — a second compile of an identical
    pair pays zero mapper restarts,
  * spatial fabrics (no time multiplexing) go through the analytic
    ``spatial_ii`` model,
  * mapping-free backends (``interp``) skip mapping entirely,
  * successful mappings are lowered once to the dense linked tables
    (``core.lowering.LinkedConfig``) that the ``sim``, ``torch`` and ``cuda``
    engines all execute — memoized next to the ``MapResult`` under the
    same key, so a warm compile re-lowers nothing,
  * every lowered configuration is statically verified
    (``repro_torch.analysis.verifier``: port oversubscription, unresolved
    wire chains, table integrity, ...) — error findings abort the
    compile with a rendered ``VerifyError``; warnings ride along on
    ``Executable.check_report``,
  * every pass reports name / wall-time / stats into
    ``CompileInfo.passes`` for tooling and the DSE front-end.

The low-level functions remain importable from ``repro_torch.core`` — this is a
new stable surface, not a break.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.mapper import get_strategy
from repro_torch.ual.backends import get_backend
from repro_torch.ual.cache import MappingCache
from repro_torch.ual.executable import CompileInfo, Executable
from repro_torch.ual.pipeline import CompileContext, Pipeline, default_pipeline
from repro_torch.ual.program import Program
from repro_torch.ual.target import Target


def compile(program: Program, target: Target, *,
            cache: Optional[MappingCache] = None,
            use_cache: bool = True,
            pipeline: Optional[Pipeline] = None) -> Executable:
    """Run ``program`` through the compile pipeline for ``target``.

    ``cache=None`` uses the process-wide default (in-process dict backed by
    an on-disk pickle directory); ``use_cache=False`` forces a cold map and
    does not store the result.  Targets carrying a ``label_fn`` always
    compile cold: the hook is unhashable, so caching it would serve stale
    placements.  ``pipeline`` swaps the default pass list for a custom one
    (extra analysis passes, alternative mapping passes).
    """
    from repro_torch import obs
    t0 = time.perf_counter()
    backend = get_backend(target.backend)   # fail fast on unknown names
    if target.fabric.temporal and backend.requires_config:
        get_strategy(target.strategy)       # ...and unknown strategies
    ctx = CompileContext(program, target, cache=cache, use_cache=use_cache,
                         backend=backend)
    with obs.tracer().span(f"compile:{program.name}", cat="compile",
                           args={"fabric": target.fabric.name,
                                 "backend": target.backend}):
        (pipeline if pipeline is not None else default_pipeline()).run(ctx)
    info = CompileInfo(cache_hit=ctx.cache_hit,
                       mapper_restarts=ctx.restarts_paid,
                       wall_s=time.perf_counter() - t0, key=ctx.key,
                       passes=list(ctx.records))
    return Executable(program, target, ctx.result, info,
                      spatial_subgraphs=ctx.spatial_subgraphs,
                      lowered=ctx.lowered, check_report=ctx.check_report)
