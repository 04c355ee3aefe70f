"""Architecture Description Language (ADL) — Morpher-style fabric models.

The paper's ADL describes arbitrary CGRAs with three abstractions:
``Module`` (FU / RF / MU / PE / composite), ``Port`` and ``Connection``;
multiplexers are inferred from port fan-in.  This module provides

  * the ADL surface (``Module``/``Port``/``Connection`` + JSON round-trip),
  * ``Fabric`` — the elaborated topology the mapper/simulator consume,
  * builders for the paper's fabrics: ``hycube`` (single-cycle multi-hop
    crossbar interconnect, multicast), ``n2n`` (neighbor-to-neighbor with
    FU route-through), ``pace`` (8x8, four clusters, 16-bit datapath) and a
    ``spatial`` Snafu-like variant (no time multiplexing),
  * a ``tpu_pod`` builder that describes a TPU mesh in the same vocabulary
    (devices = PEs, ICI links = Connections) for the distributed scheduler.

Only scheduling-relevant semantics are modelled: FU opcode support, memory
capability, per-PE input registers, directed links, the max number of link
hops a value may traverse in one cycle (HyCUBE's clockless-repeater bypass)
and whether the interconnect multicasts.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# Opcode classes
# ---------------------------------------------------------------------------

ALU_OPS = (
    "ADD", "SUB", "MUL", "SHL", "SHR", "AND", "OR", "XOR",
    "MIN", "MAX", "ABS",
    "CMPLT", "CMPGT", "CMPEQ", "CMPNE", "CMPLE", "CMPGE",
    "SELECT", "MOVC", "NOP",
)
MEM_OPS = ("LOAD", "STORE")
ROUTE_OP = "ROUTE"  # N2N pass-through occupying an FU slot
ALL_OPS = ALU_OPS + MEM_OPS + (ROUTE_OP,)


# ---------------------------------------------------------------------------
# ADL surface (Modules / Ports / Connections)
# ---------------------------------------------------------------------------

@dataclass
class Port:
    name: str
    direction: str  # "in" | "out"


@dataclass
class Module:
    """Hierarchical hardware block.  ``kind`` in {FU, RF, MU, PE, FABRIC}."""

    name: str
    kind: str
    ops: Tuple[str, ...] = ()
    size: int = 0                      # RF: #registers, MU: #words
    ports: List[Port] = field(default_factory=list)
    submodules: List["Module"] = field(default_factory=list)
    attrs: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "ops": list(self.ops),
            "size": self.size,
            "ports": [{"name": p.name, "direction": p.direction} for p in self.ports],
            "submodules": [m.to_dict() for m in self.submodules],
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_dict(d: dict) -> "Module":
        return Module(
            name=d["name"],
            kind=d["kind"],
            ops=tuple(d.get("ops", ())),
            size=int(d.get("size", 0)),
            ports=[Port(p["name"], p["direction"]) for p in d.get("ports", [])],
            submodules=[Module.from_dict(m) for m in d.get("submodules", [])],
            attrs=dict(d.get("attrs", {})),
        )


@dataclass
class Connection:
    """Directed wire between two module ports (mux inferred at the sink)."""

    src: str  # "module.port"
    dst: str


# ---------------------------------------------------------------------------
# Elaborated fabric
# ---------------------------------------------------------------------------

@dataclass
class PEAttr:
    ops: frozenset
    is_mem: bool          # has LSU access to the shared scratchpad
    n_regs: int           # input/operand registers


@dataclass
class Fabric:
    """Elaborated CGRA topology consumed by the mapper and simulator."""

    name: str
    rows: int
    cols: int
    pes: List[PEAttr]
    links: List[Tuple[int, int]]          # directed (src_pe, dst_pe)
    max_hops: int                          # link segments traversable per cycle
    multicast: bool
    route_through_fu: bool                 # N2N: continuing a route costs an FU slot
    temporal: bool = True                  # False => spatial (no time multiplexing)
    datapath_bits: int = 32
    cm_bytes_per_pe: int = 256             # configuration memory (PACE: 0.25KB)
    n_mem_ports: int = 4                   # shared scratchpad ports
    clusters: int = 1
    link_gbps: float = 0.0                 # only for pod fabrics
    attrs: Dict[str, object] = field(default_factory=dict)

    # -- derived -----------------------------------------------------------
    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    def pe_xy(self, p: int) -> Tuple[int, int]:
        return divmod(p, self.cols)

    def out_links(self, p: int) -> List[int]:
        return self._out_links[p]

    def in_links(self, p: int) -> List[int]:
        return self._in_links[p]

    def __post_init__(self) -> None:
        self._out_links: List[List[int]] = [[] for _ in range(self.n_pes)]
        self._in_links: List[List[int]] = [[] for _ in range(self.n_pes)]
        for li, (s, d) in enumerate(self.links):
            self._out_links[s].append(li)
            self._in_links[d].append(li)
        self.mem_pes = [i for i, a in enumerate(self.pes) if a.is_mem]

    def supports(self, pe: int, op: str) -> bool:
        a = self.pes[pe]
        if op in MEM_OPS:
            return a.is_mem and op in a.ops
        return op in a.ops

    # -- serialization (Morpher parses JSON architecture files) -------------
    def to_json(self) -> str:
        d = {
            "name": self.name, "rows": self.rows, "cols": self.cols,
            "pes": [{"ops": sorted(a.ops), "is_mem": a.is_mem, "n_regs": a.n_regs}
                    for a in self.pes],
            "links": [list(ab) for ab in self.links],
            "max_hops": self.max_hops, "multicast": self.multicast,
            "route_through_fu": self.route_through_fu, "temporal": self.temporal,
            "datapath_bits": self.datapath_bits,
            "cm_bytes_per_pe": self.cm_bytes_per_pe,
            "n_mem_ports": self.n_mem_ports, "clusters": self.clusters,
            "link_gbps": self.link_gbps, "attrs": self.attrs,
        }
        return json.dumps(d, indent=1)

    @staticmethod
    def from_json(s: str) -> "Fabric":
        d = json.loads(s)
        return Fabric(
            name=d["name"], rows=d["rows"], cols=d["cols"],
            pes=[PEAttr(frozenset(p["ops"]), p["is_mem"], p["n_regs"])
                 for p in d["pes"]],
            links=[tuple(ab) for ab in d["links"]],
            max_hops=d["max_hops"], multicast=d["multicast"],
            route_through_fu=d["route_through_fu"], temporal=d["temporal"],
            datapath_bits=d["datapath_bits"],
            cm_bytes_per_pe=d["cm_bytes_per_pe"],
            n_mem_ports=d["n_mem_ports"], clusters=d["clusters"],
            link_gbps=d.get("link_gbps", 0.0), attrs=d.get("attrs", {}),
        )

    # -- ADL view ------------------------------------------------------------
    def to_adl(self) -> Module:
        """Render the fabric as a hierarchy of ADL Modules (paper Fig. 3)."""
        pes = []
        for i, a in enumerate(self.pes):
            fu = Module(f"FU{i}", "FU", ops=tuple(sorted(a.ops)))
            rf = Module(f"RF{i}", "RF", size=a.n_regs)
            subs = [fu, rf]
            if a.is_mem:
                subs.append(Module(f"LSU{i}", "MU", size=0))
            pes.append(Module(f"PE{i}", "PE", submodules=subs,
                              ports=[Port("in", "in"), Port("out", "out")]))
        return Module(self.name, "FABRIC", submodules=pes,
                      attrs={"links": len(self.links), "max_hops": self.max_hops})


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _mesh_links(rows: int, cols: int, torus: bool = False) -> List[Tuple[int, int]]:
    links = []
    for r in range(rows):
        for c in range(cols):
            p = r * cols + c
            for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                rr, cc = r + dr, c + dc
                if torus:
                    rr, cc = rr % rows, cc % cols
                elif not (0 <= rr < rows and 0 <= cc < cols):
                    continue
                q = rr * cols + cc
                if q != p:
                    links.append((p, q))
    return sorted(set(links))


def _pe_row(rows: int, cols: int, mem_cols: Sequence[int], ops: Sequence[str],
            n_regs: int) -> List[PEAttr]:
    pes = []
    base = frozenset(ops)
    for r in range(rows):
        for c in range(cols):
            is_mem = c in mem_cols
            pe_ops = base | frozenset(MEM_OPS) if is_mem else base
            pes.append(PEAttr(pe_ops, is_mem, n_regs))
    return pes


def hycube(rows: int = 4, cols: int = 4, max_hops: int = 4,
           n_regs: int = 4, datapath_bits: int = 32) -> Fabric:
    """HyCUBE: single-cycle multi-hop crossbar mesh with multicast.

    Leftmost column PEs are memory-capable (LSUs to a 4-port scratchpad).
    """
    return Fabric(
        name=f"hycube_{rows}x{cols}_h{max_hops}",
        rows=rows, cols=cols,
        pes=_pe_row(rows, cols, mem_cols=(0,), ops=ALU_OPS, n_regs=n_regs),
        links=_mesh_links(rows, cols),
        max_hops=max_hops, multicast=True, route_through_fu=False,
        temporal=True, datapath_bits=datapath_bits,
    )


def n2n(rows: int = 4, cols: int = 4, n_regs: int = 4) -> Fabric:
    """Traditional neighbor-to-neighbor CGRA: 1 hop/cycle, route-through FUs."""
    return Fabric(
        name=f"n2n_{rows}x{cols}",
        rows=rows, cols=cols,
        pes=_pe_row(rows, cols, mem_cols=(0,), ops=ALU_OPS + (ROUTE_OP,),
                    n_regs=n_regs),
        links=_mesh_links(rows, cols),
        max_hops=1, multicast=False, route_through_fu=True,
        temporal=True,
    )


def pace(max_hops: int = 4) -> Fabric:
    """PACE: 8x8 HyCUBE-style CGRA, four clusters, 16-bit datapath."""
    f = hycube(8, 8, max_hops=max_hops, datapath_bits=16)
    f.name = "pace_8x8"
    f.clusters = 4
    f.cm_bytes_per_pe = 256
    return f


def spatial(rows: int = 4, cols: int = 4) -> Fabric:
    """Snafu-like spatial fabric: no time multiplexing (one op per PE)."""
    f = n2n(rows, cols)
    f.name = f"spatial_{rows}x{cols}"
    f.temporal = False
    return f


def tpu_pod(data: int = 16, model: int = 16, pods: int = 1,
            link_gbps: float = 50.0) -> Fabric:
    """A TPU pod in ADL vocabulary: chips = PEs, ICI = Connections.

    Used by the pipeline scheduler and the roofline model; 2D ICI torus per
    pod, pod axis connected by DCN-like links (modelled as regular links with
    the same builder; bandwidth annotated).
    """
    rows, cols = data, model * pods
    return Fabric(
        name=f"tpu_pod_{pods}x{data}x{model}",
        rows=rows, cols=cols,
        pes=_pe_row(rows, cols, mem_cols=range(cols), ops=ALU_OPS, n_regs=2),
        links=_mesh_links(rows, cols, torus=True),
        max_hops=1, multicast=False, route_through_fu=False,
        temporal=True, link_gbps=link_gbps,
        attrs={"pods": pods, "data": data, "model": model},
    )


FABRIC_BUILDERS = {
    "hycube": hycube,
    "n2n": n2n,
    "pace": pace,
    "spatial": spatial,
    "tpu_pod": tpu_pod,
}
