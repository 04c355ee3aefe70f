"""Architecture-adaptive modulo-scheduling mapper (paper §III-A-2).

Given a DFG and an ADL fabric, find the minimum-II modulo schedule:

  1. MII = max(ResMII, RecMII)  [Rau's iterative modulo scheduling bounds]
  2. For II = MII, MII+1, ...: place DFG nodes in topological order with
     recurrence-cycle nodes prioritized by cycle length onto (FU, time)
     instances of the MRRG, routing every edge with Dijkstra; ports may be
     temporarily oversubscribed.
  3. Oversubscription is resolved by a pluggable ``MapperStrategy`` — the
     built-ins are (a) ``adaptive``, the SPR-inspired heuristic that
     inflates the cost of overused resources between restarts, and
     (b) ``sa``, simulated annealing that perturbs placements along a
     cooling schedule.  Third parties add strategies with
     ``register_strategy`` (also exported as ``ual.register_strategy``);
     a LISA-style label hook can bias placement candidates.

Success at an II yields a machine configuration (see `core/machine.py`).
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.adl import Fabric, MEM_OPS
from repro_torch.core.dfg import DFG
from repro_torch.core.machine import MachineConfig, emit_config
from repro_torch.core.mrrg import Occupancy, Route, Router

#: bump whenever mapping behavior changes (placement order, routing cost,
#: restart schedule, ...) — the UAL mapping cache folds this into its key,
#: so stale on-disk MapResults from an older mapper are never served
MAPPER_VERSION = 1


@dataclass
class MapResult:
    success: bool
    II: int
    mii: int
    placements: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    config: Optional[MachineConfig] = None
    schedule_len: int = 0
    restarts: int = 0
    wall_s: float = 0.0
    strategy: str = "adaptive"

    @property
    def fu_util(self) -> float:
        return self.config.utilization() if self.config else 0.0


# ---------------------------------------------------------------------------
# MII bounds
# ---------------------------------------------------------------------------

def res_mii(dfg: DFG, fabric: Fabric) -> int:
    n_fus = fabric.n_pes
    n_mem_fus = max(1, len(fabric.mem_pes))
    bounds = [
        math.ceil(len(dfg.nodes) / n_fus),
        math.ceil(dfg.n_mem_ops / n_mem_fus),
        math.ceil(dfg.n_mem_ops / max(1, fabric.n_mem_ports)),
    ]
    return max(1, *bounds)


def rec_mii(dfg: DFG) -> int:
    best = 1
    for n in dfg.nodes:
        for o in n.operands:
            if o.dist > 0:
                # cycle length = edges on the dist==0 path u..v plus back edge
                cyc = _cycle_len(dfg, o.src, n.id)
                if cyc is not None:
                    best = max(best, math.ceil(cyc / o.dist))
    return best


def _cycle_len(dfg: DFG, u: int, v: int) -> Optional[int]:
    """Edges on shortest dist==0 path v ->* u, +1 for the back edge."""
    if u == v:
        return 1
    from collections import deque
    adj = {n.id: [] for n in dfg.nodes}
    for n in dfg.nodes:
        for o in n.operands:
            if o.dist == 0:
                adj[o.src].append(n.id)
    dq, dist = deque([v]), {v: 0}
    while dq:
        x = dq.popleft()
        for y in adj[x]:
            if y not in dist:
                dist[y] = dist[x] + 1
                if y == u:
                    return dist[y] + 1
                dq.append(y)
    return None


def compute_mii(dfg: DFG, fabric: Fabric) -> int:
    return max(res_mii(dfg, fabric), rec_mii(dfg))


# ---------------------------------------------------------------------------
# Placement order (topological, recurrence cycles first)
# ---------------------------------------------------------------------------

def placement_order(dfg: DFG) -> List[int]:
    cyc_len: Dict[int, int] = {}
    for cyc in dfg.recurrence_cycles():
        for nid in cyc:
            cyc_len[nid] = max(cyc_len.get(nid, 0), len(cyc))
    dfg.compute_asap_alap(4 * len(dfg.nodes))
    indeg = {n.id: sum(1 for o in n.operands if o.dist == 0) for n in dfg.nodes}
    ready = [i for i, d in indeg.items() if d == 0]
    order = []
    while ready:
        ready.sort(key=lambda i: (-cyc_len.get(i, 0), dfg.nodes[i].asap, i))
        u = ready.pop(0)
        order.append(u)
        for (v, _) in dfg.users[u]:
            cnt = sum(1 for o in dfg.nodes[v].operands
                      if o.src == u and o.dist == 0)
            if cnt:
                indeg[v] -= cnt
                if indeg[v] == 0:
                    ready.append(v)
    return order


# ---------------------------------------------------------------------------
# The mapper
# ---------------------------------------------------------------------------

class ModuloMapper:
    def __init__(self, dfg: DFG, fabric: Fabric, II: int, seed: int = 0,
                 label_fn: Optional[Callable[[int, int, int], float]] = None):
        self.dfg = dfg
        self.f = fabric
        self.II = II
        self.occ = Occupancy(fabric, II)
        self.router = Router(fabric, self.occ)
        self.rng = random.Random(seed)
        self.label_fn = label_fn      # LISA-style placement bias hook
        self.placements: Dict[int, Tuple[int, int]] = {}
        self.value_tree: Dict[int, Dict[Tuple, bool]] = {}
        self.value_routes: Dict[int, List[Route]] = {}
        self._order = placement_order(dfg)

    # -- route bookkeeping ----------------------------------------------------
    def _commit(self, rt: Route) -> None:
        for (k, t) in rt.keys:
            self.occ.add(k, rt.vid, t)
        tree = self.value_tree.setdefault(rt.vid, {})
        for n in rt.path:
            tree[n] = True
        self.value_routes.setdefault(rt.vid, []).append(rt)

    def _rip_value(self, vid: int) -> List[Tuple[int, int]]:
        """Remove all routes of a value; returns its (sink, operand) edges."""
        edges = []
        for rt in self.value_routes.get(vid, []):
            for (k, _) in rt.keys:
                self.occ.remove(k, vid)
            edges.append((rt.sink_node, rt.sink_operand))
        self.value_routes[vid] = []
        self.value_tree[vid] = {}
        return edges

    def _route_edge(self, vid: int, sink: int, k: int) -> Optional[Route]:
        pp, tp = self.placements[vid]
        pv, tv = self.placements[sink]
        d = self.dfg.nodes[sink].operands[k].dist
        tc = tv + d * self.II
        return self.router.route(vid, self.value_tree.get(vid, {}),
                                 pp, tp, sink, k, pv, tc)

    # -- candidate generation ---------------------------------------------------
    def _candidates(self, nid: int) -> List[Tuple[int, int]]:
        n = self.dfg.nodes[nid]
        pes = (self.f.mem_pes if n.op in MEM_OPS
               else [p for p in range(self.f.n_pes) if self.f.supports(p, n.op)])
        earliest = max(0, n.asap)
        latest = None
        for o in n.operands:
            if o.src in self.placements:
                _, tp = self.placements[o.src]
                earliest = max(earliest, tp + 1 - o.dist * self.II)
            else:
                # modulo constraint through an unplaced producer: it cannot
                # execute before its own ASAP, so this node cannot execute
                # before asap(src) + 1 - dist*II  (critical for recurrence
                # sinks placed ahead of their back-edge source)
                earliest = max(earliest,
                               self.dfg.nodes[o.src].asap + 1 - o.dist * self.II)
        for (v, k) in self.dfg.users[nid]:
            if v in self.placements:
                d = self.dfg.nodes[v].operands[k].dist
                _, tv = self.placements[v]
                ub = tv + d * self.II - 1
                latest = ub if latest is None else min(latest, ub)
        t_hi = earliest + self.II - 1
        if latest is not None:
            t_hi = min(t_hi, latest)
        if t_hi < earliest:
            return []
        # rank PEs by proximity to placed parents (cheap heuristic)
        parents = [self.placements[o.src][0] for o in n.operands
                   if o.src in self.placements]

        def pe_rank(p: int) -> float:
            if not parents:
                base = 0.0
            else:
                base = sum(self._dist(p, q) for q in parents)
            if self.label_fn is not None:
                base += self.label_fn(nid, p, self.II)
            return base + 0.01 * self.rng.random()

        pes = sorted(pes, key=pe_rank)
        out = []
        for t in range(earliest, t_hi + 1):
            for p in pes:
                out.append((p, t))
        return out

    def _dist(self, p: int, q: int) -> int:
        (r1, c1), (r2, c2) = self.f.pe_xy(p), self.f.pe_xy(q)
        d = abs(r1 - r2) + abs(c1 - c2)
        return (d + self.f.max_hops - 1) // self.f.max_hops

    # -- place one node -----------------------------------------------------------
    def _try_place(self, nid: int, pe: int, t: int
                   ) -> Optional[Tuple[float, List[Route]]]:
        n = self.dfg.nodes[nid]
        fu_key = ("FU", pe, t % self.II)
        cost = self.occ.cost(fu_key, nid)
        self.occ.add(fu_key, nid, t)
        keys = [(fu_key, t)]
        if n.op in MEM_OPS:
            mk = ("MEM", t % self.II)
            cost += self.occ.cost(mk, nid)
            self.occ.add(mk, nid, t)
            keys.append((mk, t))
        self.placements[nid] = (pe, t)
        routes: List[Route] = []
        ok = True
        for k, o in enumerate(n.operands):
            if o.src in self.placements:          # includes self-recurrences
                rt = self._route_edge(o.src, nid, k)
                if rt is None:
                    ok = False
                    break
                self._commit(rt)
                routes.append(rt)
                cost += sum(self.occ.cost(kk, o.src) for (kk, _) in rt.keys)
        if ok:
            for (v, k) in self.dfg.users[nid]:
                if v in self.placements and v != nid:
                    rt = self._route_edge(nid, v, k)
                    if rt is None:
                        ok = False
                        break
                    self._commit(rt)
                    routes.append(rt)
                    cost += sum(self.occ.cost(kk, nid) for (kk, _) in rt.keys)
        if not ok:
            self._undo_place(nid, keys, routes)
            return None
        conflicts = 0
        for (k, _) in keys:
            if len(self.occ.users(k)) > self.occ.capacity(k):
                conflicts += 1
        for rt in routes:
            for (k, _) in rt.keys:
                if len(self.occ.users(k)) > self.occ.capacity(k):
                    conflicts += 1
        return cost, conflicts, routes + [Route(nid, -1, -1, [], keys, None)]

    def _undo_place(self, nid: int, keys: List, routes: List[Route]) -> None:
        for rt in routes:
            for (k, _) in rt.keys:
                self.occ.remove(k, rt.vid)
            lst = self.value_routes.get(rt.vid, [])
            if rt in lst:
                lst.remove(rt)
            # rebuild tree for the value
            self._rebuild_tree(rt.vid)
        for (k, _) in keys:
            self.occ.remove(k, nid)
        del self.placements[nid]

    def _rebuild_tree(self, vid: int) -> None:
        tree: Dict[Tuple, bool] = {}
        for rt in self.value_routes.get(vid, []):
            for n in rt.path:
                tree[n] = True
        self.value_tree[vid] = tree

    # -- full placement pass ----------------------------------------------------
    def place_all(self, pes_per_t: int = 3, max_cands: int = 64) -> bool:
        """Place every node: explore the full time window (all t in the II-wide
        range), a few best-ranked PEs per t, preferring conflict-free spots.
        ``max_cands`` bounds per-node search so large DFGs map in seconds."""
        for nid in self._order:
            cands = self._candidates(nid)
            if not cands:
                return False
            by_t: Dict[int, List[int]] = {}
            for (pe, t) in cands:
                by_t.setdefault(t, []).append(pe)
            best = None          # (conflicts, cost, pe, t)
            tried = 0
            for t in sorted(by_t):
                if tried >= max_cands and best is not None:
                    break
                for pe in by_t[t][:pes_per_t]:
                    tried += 1
                    res = self._try_place(nid, pe, t)
                    if res is None:
                        continue
                    cost, conflicts, routes = res
                    cost += 0.05 * t          # mild schedule-length pressure
                    cand = (conflicts, cost, pe, t)
                    if best is None or cand[:2] < best[:2]:
                        best = cand
                    self._undo_full(nid, routes)
                if best is not None and best[0] == 0:
                    break        # conflict-free placement found at this t
            if best is None:
                return False
            _, _, pe, t = best
            if self._try_place(nid, pe, t) is None:
                return False     # should not happen (same occupancy state)
        return True

    def _undo_full(self, nid: int, routes: List[Route]) -> None:
        # last sentinel route holds the FU/MEM keys
        *real, sent = routes
        self._undo_place(nid, sent.keys, real)

    # -- perturbation (simulated annealing) ----------------------------------------
    def _rip_node(self, nid: int) -> List[Tuple[int, List[Tuple[int, int]]]]:
        """Rip a node's placement + all routes touching it; return re-route work."""
        n = self.dfg.nodes[nid]
        pe, t = self.placements[nid]
        self.occ.remove(("FU", pe, t % self.II), nid)
        if n.op in MEM_OPS:
            self.occ.remove(("MEM", t % self.II), nid)
        work = []
        # own value routes
        self._rip_value(nid)
        # parent values: rip whole net, remember their edges
        parents = {o.src for o in n.operands if o.src in self.placements
                   and o.src != nid}
        for pvid in parents:
            edges = self._rip_value(pvid)
            work.append((pvid, edges))
        del self.placements[nid]
        return work

    def sa_polish(self, max_iters: int = 400, t0: float = 3.0,
                  t1: float = 0.05) -> bool:
        if not all(n.id in self.placements for n in self.dfg.nodes):
            return False
        energy = len(self.occ.overused())
        if energy == 0:
            return True
        for it in range(max_iters):
            temp = t0 * (t1 / t0) ** (it / max_iters)
            over = self.occ.overused()
            if not over:
                return True
            # pick a node involved with an overused resource
            over_set = set(over)
            cand_nodes = []
            for vid, rts in self.value_routes.items():
                for rt in rts:
                    if any(k in over_set for (k, _) in rt.keys):
                        cand_nodes.extend([vid, rt.sink_node])
            for nid, (pe, t) in self.placements.items():
                if ("FU", pe, t % self.II) in over_set:
                    cand_nodes.append(nid)
            if not cand_nodes:
                return False
            nid = self.rng.choice(cand_nodes)
            snapshot = len(self.occ.overused())
            work = self._rip_node(nid)
            cands = self._candidates(nid)
            if not cands:
                return False
            pe, t = self.rng.choice(cands[:max(1, len(cands) // 2)])
            res = self._try_place(nid, pe, t)
            if res is None:
                # fall back to any feasible candidate
                placed = False
                for (pe, t) in cands:
                    if self._try_place(nid, pe, t) is not None:
                        placed = True
                        break
                if not placed:
                    return False
            # re-route ripped parent nets
            for pvid, edges in work:
                for (sink, k) in edges:
                    if sink in self.placements and pvid in self.placements:
                        rt = self._route_edge(pvid, sink, k)
                        if rt is None:
                            return False
                        self._commit(rt)
            new_energy = len(self.occ.overused())
            if new_energy > snapshot and \
               self.rng.random() > math.exp(-(new_energy - snapshot) / temp):
                # accept anyway with low probability (no revert — random walk)
                pass
            if new_energy == 0:
                return True
        return len(self.occ.overused()) == 0

    # -- result -----------------------------------------------------------------
    def all_routes(self) -> List[Route]:
        return [rt for rts in self.value_routes.values() for rt in rts]


# ---------------------------------------------------------------------------
# Mapper strategies (pluggable registry)
# ---------------------------------------------------------------------------

class MapperStrategy:
    """How one mapping attempt resolves resource oversubscription.

    ``map_dfg`` owns the II search and the restart schedule; the strategy
    owns what happens *within* one attempt (``attempt``) and how failure
    feedback carries into the next restart (``adapt``).  Subclass and
    register under a name to make it addressable from ``Target.strategy``::

        class MyStrategy(MapperStrategy):
            name = "mine"
            def attempt(self, m):
                return m.place_all() and not m.occ.overused()

        register_strategy("mine", MyStrategy())
    """

    name: str = "?"

    def attempt(self, m: "ModuloMapper") -> bool:
        """Run one full mapping attempt on a fresh ``ModuloMapper`` whose
        occupancy history was seeded by the previous ``adapt``; return True
        when every node is placed and no resource is oversubscribed."""
        raise NotImplementedError

    def adapt(self, m: "ModuloMapper") -> Dict:
        """Between restarts: return the occupancy history carried into the
        next attempt (SPR-style cost inflation of overused resources by
        default — subclasses may return ``{}`` to restart from scratch)."""
        m.occ.bump_hist(m.occ.overused(), 1.0)
        return m.occ.hist


class AdaptiveStrategy(MapperStrategy):
    """SPR-inspired: rely purely on inter-restart history cost inflation."""

    name = "adaptive"

    def attempt(self, m: "ModuloMapper") -> bool:
        return m.place_all() and not m.occ.overused()


class SAStrategy(MapperStrategy):
    """Adaptive placement, then simulated-annealing polish of conflicts."""

    name = "sa"

    def __init__(self, max_iters: int = 400, t0: float = 3.0,
                 t1: float = 0.05):
        self.max_iters, self.t0, self.t1 = max_iters, t0, t1

    def attempt(self, m: "ModuloMapper") -> bool:
        if not m.place_all():
            return False
        if not m.occ.overused():
            return True
        return m.sa_polish(self.max_iters, self.t0, self.t1)


MAPPER_STRATEGIES: Dict[str, MapperStrategy] = {}


def register_strategy(name: str, strategy: MapperStrategy,
                      overwrite: bool = False) -> None:
    """Register a mapper strategy under ``name``.

    Registering an existing name raises unless ``overwrite=True`` — silent
    replacement is how two plugins stomp each other.
    """
    if name in MAPPER_STRATEGIES and not overwrite:
        raise ValueError(f"strategy {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    if not isinstance(strategy, MapperStrategy):
        raise TypeError(f"strategy must be a core.mapper.MapperStrategy, "
                        f"got {type(strategy).__name__}")
    MAPPER_STRATEGIES[name] = strategy


def get_strategy(name: str) -> MapperStrategy:
    if name not in MAPPER_STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"registered: {sorted(MAPPER_STRATEGIES)}")
    return MAPPER_STRATEGIES[name]


def list_strategies() -> List[str]:
    return sorted(MAPPER_STRATEGIES)


register_strategy("adaptive", AdaptiveStrategy())
register_strategy("sa", SAStrategy())


def map_dfg(dfg: DFG, fabric: Fabric, ii_max: int = 48, seed: int = 0,
            strategy="adaptive", max_restarts: int = 8,
            label_fn=None, time_budget_s: Optional[float] = 90.0) -> MapResult:
    """Map a DFG onto a fabric, minimizing II (paper's main toolchain entry).

    ``strategy`` is a registered name (see ``list_strategies``) or a
    ``MapperStrategy`` instance.  Restart schedule: the full
    ``max_restarts`` attempts are spent at MII (where effort pays in II
    quality); higher IIs get fewer attempts, and once ``time_budget_s`` is
    exceeded each II gets a single attempt — bounding compile time the way
    a production scheduler must, at the cost of a possibly +1..2 II on
    pathological kernels.
    """
    t_start = time.perf_counter()
    strat = get_strategy(strategy) if isinstance(strategy, str) else strategy
    sname = strategy if isinstance(strategy, str) else strat.name
    mii = compute_mii(dfg, fabric)
    restarts_total = 0
    for II in range(mii, ii_max + 1):
        hist: Dict = {}
        if II == mii:
            attempts = max_restarts
        elif II <= mii + 2:
            attempts = max(2, max_restarts // 2)
        else:
            attempts = max(2, max_restarts // 4)
        if time_budget_s is not None and \
           time.perf_counter() - t_start > time_budget_s:
            attempts = 1
        for attempt in range(attempts):
            m = ModuloMapper(dfg, fabric, II, seed=seed * 1000 + attempt,
                             label_fn=label_fn)
            m.occ.hist = hist
            restarts_total += 1
            if strat.attempt(m):
                cfg = emit_config(dfg, fabric, II, m.placements, m.all_routes())
                sched = max(t for (_, t) in m.placements.values()) + 1
                return MapResult(True, II, mii, dict(m.placements), cfg,
                                 schedule_len=sched, restarts=restarts_total,
                                 wall_s=time.perf_counter() - t_start,
                                 strategy=sname)
            hist = strat.adapt(m)
    return MapResult(False, -1, mii, restarts=restarts_total,
                     wall_s=time.perf_counter() - t_start, strategy=sname)


# ---------------------------------------------------------------------------
# Spatial (Snafu-like) mapping model — paper Fig. 9 baseline
# ---------------------------------------------------------------------------

def spatial_ii(dfg: DFG, fabric: Fabric) -> Tuple[int, int]:
    """(II, n_subgraphs) for a spatial fabric.

    Each op statically owns a PE; if the DFG exceeds the array it is split
    into topologically contiguous subgraphs executed to completion one after
    another (paper §II), so the effective II is the sum of per-subgraph IIs.
    Model details (what makes spatial II >= spatio-temporal II in practice):

      * boundary values spill through the scratchpad — a STORE in the
        producer subgraph AND a LOAD in the consumer subgraph, both
        counted against the memory ports;
      * a recurrence cycle on a spatial fabric pays PE-to-PE routing for
        every edge (dependent ops sit on DISTINCT PEs; neighbor transfer
        is >= 1 cycle), so a k-op cycle bounds II by ~2k (compute + hop),
        vs the temporal mapper which can chain same-PE slots / use
        single-cycle multi-hop paths;
      * a recurrence crossing a subgraph split serializes iterations
        through the scratchpad (store + reload per iteration).
    """
    order = placement_order(dfg)
    cap = fabric.n_pes
    mem_cap = max(1, len(fabric.mem_pes))
    parts: List[List[int]] = []
    cur: List[int] = []
    cur_mem = 0
    for nid in order:
        is_mem = dfg.nodes[nid].op in MEM_OPS
        if len(cur) >= cap or (is_mem and cur_mem >= mem_cap):
            parts.append(cur)
            cur, cur_mem = [], 0
        cur.append(nid)
        cur_mem += int(is_mem)
    if cur:
        parts.append(cur)
    part_of = {nid: i for i, part in enumerate(parts) for nid in part}

    # per-part memory pressure: own mem ops + boundary stores + loads
    memops = [sum(1 for nid in part if dfg.nodes[nid].op in MEM_OPS)
              for part in parts]
    for n in dfg.nodes:
        for o in n.operands:
            if o.dist == 0 and part_of[o.src] != part_of[n.id]:
                memops[part_of[o.src]] += 1      # boundary store
                memops[part_of[n.id]] += 1       # boundary load

    # recurrence bounds with spatial routing latency
    rec_bound = [1] * len(parts)
    cross_penalty = 0
    for cyc in dfg.recurrence_cycles():
        k = len(cyc)
        owners = {part_of[nid] for nid in cyc}
        lat = k if k == 1 else 2 * k             # compute + neighbor hops
        if len(owners) == 1:
            p = owners.pop()
            rec_bound[p] = max(rec_bound[p], lat)
        else:
            # iteration serializes through the scratchpad across parts
            cross_penalty = max(cross_penalty, lat + 2)

    total = 0
    for i, part in enumerate(parts):
        ii_k = max(1, rec_bound[i],
                   math.ceil(memops[i] / max(1, fabric.n_mem_ports)))
        total += ii_k
    total = max(total, cross_penalty, rec_mii(dfg))
    return total, len(parts)
