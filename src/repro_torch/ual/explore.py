"""Parallel design-space exploration over the UAL compile pipeline.

The paper positions the toolchain as the substrate for DSE (REVAMP-style
sweeps of fabric variants); this module is the front-end:

  * ``compile_many(pairs, workers=N)`` — compile a grid of
    ``(Program, Target)`` pairs, fanning the *unique cold* mapping
    problems over a process pool.  Identical ``(program.digest,
    target.digest)`` pairs map exactly once, and pairs already in the
    mapping cache (in-process or on disk) never enter the pool at all —
    the sweep pays exactly one modulo mapping per unique design point.
  * ``explore(program, space, workers=N)`` — sweep fabric builders ×
    mapper strategies × knobs, and return a Pareto report over
    (II, mapper wall-time, GOPS/W via the PACE-calibrated
    ``core.energy`` model).

Worker payloads are ``(laid DFG, fabric, mapper knobs)`` — deliberately
not the full ``Program``/``Target`` (whose ``make_mem``/``label_fn``
hooks may be unpicklable lambdas).  Targets that cannot be fanned out
(spatial fabrics, mapping-free backends, ``label_fn`` carriers) compile
serially in the parent, through the same pipeline.  The pool uses the
``fork`` start method where available so strategies registered at
runtime (``ual.register_strategy``) are visible in the workers.

On a card the parent has usually initialised CUDA before it explores.  A
forked child cannot use CUDA and must touch no torch op, so ``_map_worker``
runs the modulo mapper only (``core.mapper``: Python and numpy) and ships
back a ``MapResult`` of numpy arrays; lowering, verification and any
validation on the card happen in the parent.  Nothing this module imports
touches a device.
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import (Dict, Iterable, List, Optional, Sequence, Tuple, Union)

from repro_torch.core.adl import Fabric
from repro_torch.core.energy import point_efficiency_gops_w
from repro_torch.core.mapper import MapResult, map_dfg
from repro_torch.ual.backends import get_backend
from repro_torch.ual.cache import MappingCache, default_cache
from repro_torch.ual.compiler import compile as _compile
from repro_torch.ual.executable import Executable
from repro_torch.ual.program import Program
from repro_torch.ual.target import FABRICS, Target

Pair = Tuple[Program, Target]


def _map_worker(payload) -> MapResult:
    """Process-pool entry: one cold modulo mapping (module-level so it
    pickles under every start method).  The mapper is Python and numpy:
    a child forked from a parent holding a CUDA context runs it safely."""
    laid, fabric, knobs = payload
    return map_dfg(laid, fabric, **knobs)


def _pool(workers: int) -> ProcessPoolExecutor:
    if "fork" in multiprocessing.get_all_start_methods():
        ctx = multiprocessing.get_context("fork")
        return ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
    return ProcessPoolExecutor(max_workers=workers)


def compile_many(pairs: Iterable[Pair], workers: Optional[int] = None,
                 *, cache: Optional[MappingCache] = None,
                 use_cache: bool = True) -> List[Executable]:
    """Compile every ``(program, target)`` pair; returns executables in
    input order.

    Cache-aware dedup before any work is scheduled: pairs whose
    ``(program.digest, target.digest)`` is already cached are served warm
    and never enter the pool; the remaining *unique* cold keys map exactly
    once each, in parallel across ``workers`` processes (default: the CPU
    count).  With ``use_cache=False`` every pair compiles cold and
    serially — there is no dedup identity to share results through.
    """
    pairs = list(pairs)
    c = cache if cache is not None else default_cache()
    cold: Dict[Tuple[str, str], List[int]] = {}
    for i, (program, target) in enumerate(pairs):
        backend = get_backend(target.backend)   # fail fast on unknown names
        fan_out = (target.fabric.temporal and backend.requires_config
                   and use_cache and target.label_fn is None)
        if fan_out and not c.contains((program.digest, target.digest)):
            cold.setdefault((program.digest, target.digest), []).append(i)

    pool_results: Dict[Tuple[str, str], MapResult] = {}
    if cold:
        items = []
        for key, idxs in cold.items():
            program, target = pairs[idxs[0]]
            items.append((key, (program.laid, target.fabric,
                                dict(ii_max=target.ii_max, seed=target.seed,
                                     strategy=target.strategy,
                                     max_restarts=target.max_restarts,
                                     time_budget_s=target.time_budget_s))))
        n = max(1, min(workers or os.cpu_count() or 1, len(items)))
        if n == 1:
            results = [_map_worker(p) for _, p in items]
        else:
            with _pool(n) as pool:
                results = list(pool.map(_map_worker,
                                        [p for _, p in items]))
        for (key, _), result in zip(items, results):
            # same persistence contract as the mapping pass: failures are
            # memoized in-process only, never pinned on disk
            c.put(key, result, memory_only=not result.success)
            pool_results[key] = result

    exes = [_compile(program, target, cache=c if use_cache else None,
                     use_cache=use_cache)
            for program, target in pairs]

    # the first pair of each pool-mapped key did pay the mapping (in a
    # worker) — attribute the true cost instead of the warm-hit it saw
    for key, idxs in cold.items():
        result = pool_results[key]
        info = exes[idxs[0]].compile_info
        info.cache_hit = False
        info.mapper_restarts = result.restarts
        for rec in info.passes:
            if rec.name == "mapping":
                # keep wall_s >= sum(pass times): swap the warm-lookup time
                # for the worker's true mapping time in both places
                info.wall_s += result.wall_s - rec.wall_s
                rec.wall_s = result.wall_s
                rec.stats = dict(rec.stats, cache="pool",
                                 restarts=result.restarts)
    return exes


# ---------------------------------------------------------------------------
# explore(): sweep a design space, report the Pareto frontier
# ---------------------------------------------------------------------------

FabricSpec = Union[str, Tuple[str, Dict[str, object]], Fabric]


@dataclass(eq=False)                 # identity eq: points wrap executables
class DesignPoint:
    """One swept configuration with its measured/modelled objectives."""

    fabric: str
    strategy: str
    knobs: Dict[str, object]
    success: bool
    II: Optional[int]
    mii: Optional[int]
    mapper_wall_s: float         # cost of the mapping itself (cached or not)
    restarts: int
    gops_w: Optional[float]      # PACE-calibrated model at the point's util
    cache_hit: bool
    pass_times: Dict[str, float]
    executable: Executable = field(repr=False)

    def row(self) -> list:
        return [self.fabric, self.strategy,
                " ".join(f"{k}={v}" for k, v in self.knobs.items()) or "-",
                self.II if self.success else "FAIL",
                f"{self.mapper_wall_s:.2f}s",
                f"{self.gops_w:.0f}" if self.gops_w is not None else "-",
                "warm" if self.cache_hit else "cold"]


@dataclass
class ExploreReport:
    """``explore()``'s result: every point, the Pareto subset, sweep stats."""

    program: str
    points: List[DesignPoint]
    pareto: List[DesignPoint]
    wall_s: float
    n_mapped: int                # modulo mappings actually performed
    n_warm: int                  # points served from the cache

    def render(self) -> str:
        if not self.points:
            return "explore: no design points"
        rows = [p.row() + ["*" if p in self.pareto else ""]
                for p in self.points]
        head = ["fabric", "strategy", "knobs", "II", "map", "GOPS/W",
                "cache", "pareto"]
        widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
                  for i, h in enumerate(head)]

        def line(vals):
            return "  ".join(str(v).rjust(w) for v, w in zip(vals, widths))

        table = "\n".join([line(head), line(["-" * w for w in widths])]
                          + [line(r) for r in rows])
        return (table
                + f"\n{len(self.pareto)} Pareto-optimal point(s); "
                  f"{self.n_mapped} mapping(s) paid for "
                  f"{len(self.points)} point(s) in {self.wall_s:.1f}s")

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "wall_s": self.wall_s,
            "n_mapped": self.n_mapped,
            "n_warm": self.n_warm,
            "points": [{
                "fabric": p.fabric, "strategy": p.strategy,
                "knobs": {k: str(v) for k, v in p.knobs.items()},
                "success": p.success, "II": p.II, "mii": p.mii,
                "mapper_wall_s": p.mapper_wall_s, "restarts": p.restarts,
                "gops_w": p.gops_w, "cache_hit": p.cache_hit,
                "pass_times": p.pass_times,
                "pareto": p in self.pareto,
            } for p in self.points],
        }


def _resolve_fabric(spec: FabricSpec) -> Fabric:
    if isinstance(spec, Fabric):
        return spec
    if isinstance(spec, str):
        name, kwargs = spec, {}
    else:
        name, kwargs = spec
    if name not in FABRICS:
        raise KeyError(f"unknown fabric {name!r}; "
                       f"registered: {sorted(FABRICS)}")
    return FABRICS[name](**kwargs)


def space_targets(space: Dict[str, Sequence]) -> List[Tuple[Target, Dict]]:
    """Cartesian product of a design space into concrete Targets.

    ``space`` axes: ``fabric`` (required — names, ``(name, kwargs)`` pairs
    or ``Fabric`` instances), ``strategy`` (default ``("adaptive",)``),
    ``backend`` (default ``"sim"``), plus any mapper-knob field of
    ``Target`` (``seed``, ``ii_max``, ``max_restarts``, ``time_budget_s``).
    """
    space = dict(space)
    fabrics = space.pop("fabric", None)
    if not fabrics:
        raise ValueError("space needs a non-empty 'fabric' axis")
    strategies = space.pop("strategy", ("adaptive",))
    if isinstance(strategies, str):
        strategies = (strategies,)
    backends = space.pop("backend", ("sim",))
    if isinstance(backends, str):
        backends = (backends,)
    knob_names = {f.name for f in Target.__dataclass_fields__.values()
                  if f.name not in ("fabric", "backend", "strategy",
                                    "label_fn")}
    bad = set(space) - knob_names
    if bad:
        raise ValueError(f"unknown space axes {sorted(bad)}; "
                         f"knob axes: {sorted(knob_names)}")
    axes = list(space)
    out = []
    for spec in fabrics:
        fabric = _resolve_fabric(spec)
        for strat, backend, *vals in itertools.product(
                strategies, backends, *space.values()):
            knobs = dict(zip(axes, vals))
            out.append((Target(fabric, backend=backend, strategy=strat,
                               **knobs), knobs))
    if not out:
        raise ValueError("design space is empty: every axis needs at "
                         "least one value")
    return out


def _dominates(a: DesignPoint, b: DesignPoint) -> bool:
    ge = (a.II <= b.II and a.mapper_wall_s <= b.mapper_wall_s
          and (a.gops_w or 0.0) >= (b.gops_w or 0.0))
    gt = (a.II < b.II or a.mapper_wall_s < b.mapper_wall_s
          or (a.gops_w or 0.0) > (b.gops_w or 0.0))
    return ge and gt


def pareto_front(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """The feasible points no other feasible point dominates (min II, min
    mapping time, max GOPS/W), in input order."""
    feasible = [p for p in points if p.success]
    return [p for p in feasible
            if not any(_dominates(q, p) for q in feasible)]


def explore(program: Program, space: Dict[str, Sequence], *,
            workers: Optional[int] = None,
            cache: Optional[MappingCache] = None,
            use_cache: bool = True, vdd: float = 0.6) -> ExploreReport:
    """Sweep ``program`` over a fabric × strategy × knob design space.

    Compiles every point through ``compile_many`` (parallel, deduped,
    cache-aware — each unique digest pair maps exactly once) and scores it
    on (II, mapper wall-time, GOPS/W at ``vdd``); the report carries every
    point's per-pass timings and the Pareto-optimal subset
    (min II, min mapping time, max GOPS/W)::

        report = ual.explore(program, {
            "fabric": [("hycube", dict(rows=4, cols=4)),
                       ("n2n", dict(rows=4, cols=4)), "pace"],
            "strategy": ["adaptive", "sa"],
            "seed": [0, 1],
        }, workers=4)
        print(report.render())
    """
    t0 = time.perf_counter()
    targets = space_targets(space)
    exes = compile_many([(program, t) for t, _ in targets], workers=workers,
                        cache=cache, use_cache=use_cache)
    n_ops = len(program.laid.nodes)
    points = []
    for (target, knobs), exe in zip(targets, exes):
        r = exe.map_result
        ok = exe.success and r is not None
        ii = r.II if ok else None
        wall = (r.wall_s if r is not None and r.wall_s > 0
                else exe.compile_info.pass_times.get("mapping", 0.0))
        points.append(DesignPoint(
            fabric=target.fabric.name, strategy=target.strategy,
            knobs=knobs, success=ok, II=ii,
            mii=r.mii if r is not None else None,
            mapper_wall_s=wall,
            restarts=r.restarts if r is not None else 0,
            gops_w=(point_efficiency_gops_w(n_ops, ii, target.fabric.n_pes,
                                            vdd=vdd) if ok else None),
            cache_hit=exe.compile_info.cache_hit,
            pass_times=exe.compile_info.pass_times,
            executable=exe))
    pareto = pareto_front(points)
    n_mapped = sum(1 for p in points
                   if p.success and not p.cache_hit
                   and p.executable.target.fabric.temporal)
    return ExploreReport(program.name, points, pareto,
                         time.perf_counter() - t0, n_mapped,
                         sum(1 for p in points if p.cache_hit))
