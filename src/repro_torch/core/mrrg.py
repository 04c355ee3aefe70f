"""Modulo Routing Resource Graph: occupancy model + Dijkstra router.

The MRRG unrolls the fabric over a candidate II; FUs, links and registers
become schedulable resources with capacity checked modulo II (paper
§III-B-2).  HyCUBE's single-cycle multi-hop interconnect appears as
within-cycle link chaining (up to ``max_hops`` segments); a traditional
N2N fabric instead requires a ROUTE slot on the intermediate PE's FU to
continue a path.  Multicast falls out of route-tree reuse: routing a value
to a second sink starts from every node already committed to that value's
tree at zero cost.

Search-node encodings (absolute time ``t``; capacities keyed mod II):
  ('O', pe, t)        output latch of ``pe`` holding the value during cycle t
  ('R', pe, r, t)     input register r of ``pe`` holding the value during t
  ('L', link, t, h)   value travelling link ``link`` during cycle t, h-th hop
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.adl import Fabric

Key = Tuple  # (kind, *idx, slot)

BASE_COST = {"L": 1.0, "R": 0.35, "FU": 3.0}
OVERUSE_PENALTY = 24.0


class Occupancy:
    """Per-(resource, slot mod II) usage with congestion history (SPR/PathFinder).

    Each (key, value) claim records the *absolute* cycle of the claim: the
    same value may share a resource slot across multiple route edges only at
    the same absolute time (true multicast).  A claim at a different absolute
    time would be a *different iteration* of the value — physically a
    conflict with itself — and is blocked at search time.
    """

    def __init__(self, fabric: Fabric, II: int):
        self.fabric = fabric
        self.II = II
        self.occ: Dict[Key, Dict[int, List[int]]] = {}  # key -> {vid: [count, abs_t]}
        self.hist: Dict[Key, float] = {}

    def users(self, key: Key) -> Dict[int, List[int]]:
        return self.occ.get(key, {})

    def blocked(self, key: Key, vid: int, t: int) -> bool:
        ent = self.occ.get(key, {}).get(vid)
        return ent is not None and ent[1] != t

    def add(self, key: Key, vid: int, t: int) -> None:
        d = self.occ.setdefault(key, {})
        if vid in d:
            if d[vid][1] != t:
                raise AssertionError(
                    f"value {vid} claims {key} at two times {d[vid][1]} vs {t}")
            d[vid][0] += 1
        else:
            d[vid] = [1, t]

    def remove(self, key: Key, vid: int) -> None:
        d = self.occ[key]
        d[vid][0] -= 1
        if d[vid][0] == 0:
            del d[vid]
        if not d:
            del self.occ[key]

    def overused(self) -> List[Key]:
        out = []
        for key, users in self.occ.items():
            cap = self.capacity(key)
            if len(users) > cap:
                out.append(key)
        return out

    def capacity(self, key: Key) -> int:
        if key[0] == "MEM":
            return self.fabric.n_mem_ports
        return 1

    def bump_hist(self, keys: Iterable[Key], amt: float = 1.0) -> None:
        for k in keys:
            self.hist[k] = self.hist.get(k, 0.0) + amt

    def cost(self, key: Key, vid: int) -> float:
        base = BASE_COST.get(key[0], 1.0)
        h = 1.0 + self.hist.get(key, 0.0)
        users = self.occ.get(key, {})
        extra = sum(1 for u in users if u != vid)
        over = max(0, extra + 1 - self.capacity(key))
        return base * h + OVERUSE_PENALTY * over * h

    def clear_routes(self) -> None:
        """Drop all occupancy but keep congestion history across restarts."""
        self.occ.clear()


@dataclass
class Route:
    """A committed path for one DFG edge (producer value -> one sink)."""

    vid: int
    sink_node: int
    sink_operand: int
    path: List[Tuple]                    # search nodes, source -> sink
    keys: List[Tuple[Key, int]]          # (resource, absolute time) consumed
    sink_entry: Tuple                    # last search node before the sink


class Router:
    """Dijkstra over the time-expanded resource graph."""

    def __init__(self, fabric: Fabric, occ: Occupancy):
        self.f = fabric
        self.occ = occ

    # -- expansion -----------------------------------------------------------
    def _neighbors(self, node: Tuple, vid: int, t_max: int):
        f, occ, II = self.f, self.occ, self.occ.II

        def use(key, t):
            if occ.blocked(key, vid, t):
                return None
            return [(key, t)], occ.cost(key, vid)

        kind = node[0]
        if kind == "O":
            _, p, t = node
            if t > t_max:
                return
            # write own register (value available in reg during cycle t)
            for r in range(f.pes[p].n_regs):
                u = use(("R", p, r, t % II), t)
                if u:
                    yield ("R", p, r, t), *u
            # drive out-links (crossbar / output broadcast)
            for li in f.out_links(p):
                u = use(("L", li, t % II), t)
                if u:
                    yield ("L", li, t, 1), *u
        elif kind == "L":
            _, li, t, h = node
            a, bpe = f.links[li]
            # latch into a register of the destination (held during t+1)
            if t + 1 <= t_max:
                for r in range(f.pes[bpe].n_regs):
                    u = use(("R", bpe, r, (t + 1) % II), t + 1)
                    if u:
                        yield ("R", bpe, r, t + 1), *u
            # single-cycle multi-hop chaining (HyCUBE bypass repeaters)
            if not f.route_through_fu and h < f.max_hops:
                for lj in f.out_links(bpe):
                    if f.links[lj][1] != a:          # no immediate U-turn
                        u = use(("L", lj, t % II), t)
                        if u:
                            yield ("L", lj, t, h + 1), *u
        elif kind == "R":
            _, p, r, t = node
            # hold one more cycle
            if t + 1 <= t_max:
                u = use(("R", p, r, (t + 1) % II), t + 1)
                if u:
                    yield ("R", p, r, t + 1), *u
            if f.route_through_fu:
                # N2N: continuing needs a ROUTE slot on this FU
                if t + 1 <= t_max:
                    u = use(("FU", p, t % II), t)
                    if u:
                        yield ("O", p, t + 1), *u
            else:
                # HyCUBE: crossbar forwards register contents directly
                for li in f.out_links(p):
                    u = use(("L", li, t % II), t)
                    if u:
                        yield ("L", li, t, 1), *u

    def _reaches_sink(self, node: Tuple, sink_pe: int, tc: int) -> bool:
        kind = node[0]
        if kind == "O":
            return node[1] == sink_pe and node[2] == tc
        if kind == "L":
            return self.f.links[node[1]][1] == sink_pe and node[2] == tc
        if kind == "R":
            return node[1] == sink_pe and node[3] == tc
        return False

    # -- search ---------------------------------------------------------------
    def route(self, vid: int, tree: Dict[Tuple, int], src_pe: int, t_src: int,
              sink_node: int, sink_operand: int, sink_pe: int, tc: int,
              max_cost: float = 1e9) -> Optional[Route]:
        """Route value ``vid`` (produced on src_pe at t_src) to (sink_pe, tc).

        ``tree``: search-node -> refcount of the value's committed tree; all
        of them seed the frontier at zero cost (multicast reuse).
        """
        if tc <= t_src:
            return None
        start: Dict[Tuple, float] = {("O", src_pe, t_src + 1): 0.0}
        for n in tree:
            if n not in start and self._time_of(n) <= tc:
                start[n] = 0.0
        dist: Dict[Tuple, float] = dict(start)
        prev: Dict[Tuple, Tuple] = {}
        prev_keys: Dict[Tuple, List[Key]] = {}
        pq = [(c, n) for n, c in start.items()]
        heapq.heapify(pq)
        best_sink, best_cost = None, max_cost
        while pq:
            c, n = heapq.heappop(pq)
            if c > dist.get(n, 1e18) or c >= best_cost:
                continue
            if self._reaches_sink(n, sink_pe, tc):
                best_sink, best_cost = n, c
                continue
            for nxt, keys, w in self._neighbors(n, vid, tc):
                nc = c + w
                if nc < dist.get(nxt, 1e18) and nc < best_cost:
                    dist[nxt] = nc
                    prev[nxt] = n
                    prev_keys[nxt] = keys
                    heapq.heappush(pq, (nc, nxt))
        if best_sink is None:
            return None
        # backtrack to a tree/start node (the seed is kept in the path so
        # machine emission can recover the seed->first-new-node action)
        path, keys = [best_sink], []
        node = best_sink
        while node in prev and node not in start:
            keys.extend(prev_keys[node])
            node = prev[node]
            path.append(node)
        path.reverse()
        # a path that claims the same (resource, slot) at two absolute times
        # would overlap consecutive iterations of its own value (e.g. a
        # register held >= II cycles) — physically infeasible, reject
        kk = [k for (k, _) in keys]
        if len(set(kk)) != len(kk):
            return None
        return Route(vid, sink_node, sink_operand, path, keys,
                     sink_entry=best_sink)

    @staticmethod
    def _time_of(node: Tuple) -> int:
        if node[0] == "L":
            return node[2]
        return node[-1]
