"""Dataflow-graph IR + generation (Morpher phase 1).

Morpher's compiler frontend turns annotated kernels into a data-rich DFG:
compute / memory / predication nodes with recurrence (loop-carried) edges,
scheduling hints, and data-layout constants embedded into memory nodes.
Here the frontend is:

  * ``DFGBuilder`` — a small builder DSL for loop-body kernels (the analogue
    of Morpher's annotated-C input) with explicit ``load``/``store``/
    ``counter``/``recur`` for memory and loop-carried state,
  * ``trace_into`` — ``torch.fx``-based DFG extraction for the pure-compute
    part of a kernel written with torch ops (the analogue of Morpher's
    LLVM-based DFG generation),
  * ``interpret`` — the reference executor used for automated test-vector
    validation (paper Table II's distinguishing feature),
  * ``DataLayout`` — round-robin bank allocation with base addresses folded
    into LOAD/STORE node constants (paper §III-A-1).

All values are int32 (the fabric datapath); this gives bit-exact validation
between the DFG interpreter, the cycle-accurate simulator and the CUDA
``cgra_exec`` kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.adl import MEM_OPS

INT = np.int32
_MASK = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Operand:
    src: int                 # producing node id
    dist: int = 0            # recurrence distance in iterations
    init: int = 0            # value used for iterations i < dist


@dataclass
class Node:
    id: int
    op: str
    operands: List[Operand] = field(default_factory=list)
    const: Optional[int] = None      # immediate folded into the instruction
    array: Optional[str] = None      # LOAD/STORE target array
    # -- scheduling metadata (paper: ASAP/ALAP hints, parent/child counts) --
    asap: int = 0
    alap: int = 0

    @property
    def is_mem(self) -> bool:
        return self.op in MEM_OPS


@dataclass
class DFG:
    nodes: List[Node]
    arrays: Dict[str, int]                      # name -> length (words)
    name: str = "kernel"
    outputs: Tuple[str, ...] = ()               # arrays to check after run

    def __post_init__(self) -> None:
        self.users: Dict[int, List[Tuple[int, int]]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for k, o in enumerate(n.operands):
                self.users[o.src].append((n.id, k))

    # -- structure -----------------------------------------------------------
    def topo_order(self) -> List[int]:
        """Topological order over non-recurrence (dist==0) edges."""
        indeg = {n.id: 0 for n in self.nodes}
        for n in self.nodes:
            for o in n.operands:
                if o.dist == 0:
                    indeg[n.id] += 1
        order, stack = [], sorted(i for i, d in indeg.items() if d == 0)
        while stack:
            u = stack.pop(0)
            order.append(u)
            for (v, _) in self.users[u]:
                node = self.nodes[v]
                if any(o.src == u and o.dist == 0 for o in node.operands):
                    indeg[v] -= sum(1 for o in node.operands
                                    if o.src == u and o.dist == 0)
                    if indeg[v] == 0:
                        stack.append(v)
        if len(order) != len(self.nodes):
            raise ValueError(f"{self.name}: cycle through dist==0 edges")
        return order

    def recurrence_cycles(self) -> List[List[int]]:
        """Elementary cycles that include >=1 dist>0 edge (loop recurrences).

        Found by, for every dist>0 edge (u -> v), searching a dist==0 path
        v ->* u; the recurrence cycle is that path plus the back edge.
        """
        adj0: Dict[int, List[int]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for o in n.operands:
                if o.dist == 0:
                    adj0[o.src].append(n.id)
        cycles = []
        for n in self.nodes:
            for o in n.operands:
                if o.dist > 0:
                    u, v = o.src, n.id        # value u(iter i) -> v(iter i+dist)
                    path = _bfs_path(adj0, v, u)
                    if path is not None:
                        cycles.append(path)   # v .. u, closed by back edge
                    elif u == v:
                        cycles.append([u])
        return cycles

    def compute_asap_alap(self, horizon: int) -> None:
        order = self.topo_order()
        asap = {i: 0 for i in order}
        for u in order:
            for (v, _) in self.users[u]:
                for o in self.nodes[v].operands:
                    if o.src == u and o.dist == 0:
                        asap[v] = max(asap[v], asap[u] + 1)
        alap = {i: horizon for i in order}
        for u in reversed(order):
            for o in self.nodes[u].operands:
                if o.dist == 0:
                    alap[o.src] = min(alap[o.src], alap[u] - 1)
        for n in self.nodes:
            n.asap, n.alap = asap[n.id], alap[n.id]

    @property
    def n_mem_ops(self) -> int:
        return sum(1 for n in self.nodes if n.is_mem)


def _bfs_path(adj: Dict[int, List[int]], s: int, t: int) -> Optional[List[int]]:
    if s == t:
        return [s]
    prev, q, seen = {}, [s], {s}
    while q:
        u = q.pop(0)
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                prev[v] = u
                if v == t:
                    path = [t]
                    while path[-1] != s:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                q.append(v)
    return None


# ---------------------------------------------------------------------------
# Builder DSL
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ref:
    id: int


class DFGBuilder:
    def __init__(self, name: str = "kernel"):
        self.name = name
        self._nodes: List[Node] = []
        self._arrays: Dict[str, int] = {}
        self._outputs: List[str] = []
        self._pending: Dict[int, Tuple[int, int]] = {}   # placeholder -> (init, extra_dist)
        self._bound: Dict[int, int] = {}                 # placeholder -> producer id

    # -- raw node -----------------------------------------------------------
    def op(self, opcode: str, *args, const: Optional[int] = None,
           array: Optional[str] = None) -> Ref:
        # Fold a single *trailing* immediate into the instruction const field
        # (paper: constants embedded as node metadata); any other immediate
        # becomes an explicit MOVC so operand order is preserved.
        args = list(args)
        if (const is None and args
                and isinstance(args[-1], (int, np.integer))):
            const = int(args.pop())
        operands = []
        for a in args:
            if isinstance(a, Ref):
                operands.append(Operand(a.id))
            elif isinstance(a, (int, np.integer)):
                operands.append(Operand(self.op("MOVC", const=int(a)).id))
            else:
                raise TypeError(f"bad operand {a!r}")
        nid = len(self._nodes)
        self._nodes.append(Node(nid, opcode, operands, const=const, array=array))
        return Ref(nid)

    # -- memory ---------------------------------------------------------------
    def array(self, name: str, length: int, output: bool = False) -> str:
        self._arrays[name] = int(length)
        if output:
            self._outputs.append(name)
        return name

    def load(self, array: str, idx) -> Ref:
        """LOAD: operands [idx?]; const holds the (base+)fixed offset."""
        assert array in self._arrays, f"undeclared array {array}"
        if isinstance(idx, (int, np.integer)):
            return self.op("LOAD", const=int(idx), array=array)
        return self.op("LOAD", idx, array=array)

    def store(self, array: str, idx, value) -> Ref:
        """STORE: operands [idx?, value]; const holds the fixed offset."""
        assert array in self._arrays, f"undeclared array {array}"
        if array not in self._outputs:
            self._outputs.append(array)
        if not isinstance(value, Ref):
            value = self.op("MOVC", const=int(value))
        if isinstance(idx, (int, np.integer)):
            nid = len(self._nodes)
            self._nodes.append(Node(nid, "STORE", [Operand(value.id)],
                                    const=int(idx), array=array))
            return Ref(nid)
        nid = len(self._nodes)
        self._nodes.append(Node(nid, "STORE",
                                [Operand(idx.id), Operand(value.id)],
                                array=array))
        return Ref(nid)

    # -- loop-carried state ---------------------------------------------------
    def counter(self, start: int = 0, step: int = 1) -> Ref:
        """Loop induction variable: i_t = i_{t-1} + step, i_0 = start."""
        nid = len(self._nodes)
        self._nodes.append(Node(nid, "ADD",
                                [Operand(nid, dist=1, init=start - step)],
                                const=step))
        return Ref(nid)

    def recur(self, init: int = 0, dist: int = 1) -> Ref:
        """Placeholder for a loop-carried value; close with ``bind``."""
        nid = len(self._nodes)
        self._nodes.append(Node(nid, "__PH__"))
        self._pending[nid] = (int(init), dist)
        return Ref(nid)

    def bind(self, placeholder: Ref, producer: Ref) -> None:
        assert placeholder.id in self._pending, "not a recur() placeholder"
        self._bound[placeholder.id] = producer.id

    # -- finalize ------------------------------------------------------------
    def build(self) -> DFG:
        missing = set(self._pending) - set(self._bound)
        if missing:
            raise ValueError(f"unbound recur() placeholders: {missing}")
        # rewrite operand references through placeholders
        nodes = []
        remap: Dict[int, Tuple[int, int, int]] = {}
        for ph, prod in self._bound.items():
            init, dist = self._pending[ph]
            remap[ph] = (prod, dist, init)
        keep = [n for n in self._nodes if n.op != "__PH__"]
        newid = {n.id: i for i, n in enumerate(keep)}
        for n in keep:
            ops = []
            for o in n.operands:
                if o.src in remap:
                    prod, dist, init = remap[o.src]
                    ops.append(Operand(newid[prod], o.dist + dist, init))
                else:
                    ops.append(Operand(newid[o.src], o.dist, o.init))
            nodes.append(Node(newid[n.id], n.op, ops, const=n.const,
                              array=n.array))
        return DFG(nodes, dict(self._arrays), name=self.name,
                   outputs=tuple(self._outputs))


# ---------------------------------------------------------------------------
# torch.fx-based extraction (LLVM-frontend analogue)
# ---------------------------------------------------------------------------

def _fx_targets():
    """fx call targets -> DFG opcodes, or the name of a call that
    ``trace_into`` lowers itself."""
    import builtins
    import operator

    import torch
    return {
        operator.add: "ADD", operator.sub: "SUB", operator.mul: "MUL",
        operator.and_: "AND", operator.or_: "OR", operator.xor: "XOR",
        operator.lshift: "SHL", operator.rshift: "SHR",
        operator.lt: "CMPLT", operator.gt: "CMPGT", operator.eq: "CMPEQ",
        operator.ne: "CMPNE", operator.le: "CMPLE", operator.ge: "CMPGE",
        operator.abs: "ABS", builtins.abs: "ABS", torch.abs: "ABS",
        torch.minimum: "MIN", torch.maximum: "MAX",
        operator.neg: "neg", operator.pow: "pow", torch.where: "where",
        torch.clamp: "clamp",
    }


#: fx method calls that change only a value's type, which int32 ignores
_FX_PASS = ("to", "int", "long", "type")


def trace_into(b: DFGBuilder, fn: Callable, inputs: Sequence[Ref]) -> List[Ref]:
    """Trace a pure scalar-int function written with torch ops (Python's
    operators, ``torch.where``, ``torch.minimum``/``maximum``/``clamp``,
    ``abs``, ``**`` with an int exponent) into the builder.

    ``fn`` takes len(inputs) int32 scalars and returns one or a tuple of
    int32 scalars; ``torch.fx.symbolic_trace`` records its graph, and each
    call becomes the DFG node the jaxpr walker of the JAX package makes
    for the same function written with ``jnp``: a literal operand stays
    where the function put it (a trailing one is folded into the node's
    immediate), negation is ``SUB(0, x)``, ``x ** n`` a chain of ``MUL``,
    ``torch.where(c, a, b)`` is ``SELECT(c, a, b)``, and a call on
    constants alone is folded to a ``MOVC``.  Anything else raises
    ``NotImplementedError``.
    """
    import torch.fx

    gm = torch.fx.symbolic_trace(fn)
    targets = _fx_targets()
    env: Dict[str, object] = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != len(inputs):
        raise ValueError(f"fn takes {len(placeholders)} arguments, "
                         f"{len(inputs)} inputs given")
    env.update({n.name: r for n, r in zip(placeholders, inputs)})

    def read(a):
        if isinstance(a, torch.fx.Node):
            return env[a.name]
        if isinstance(a, (bool, int, np.integer)):
            return int(a)
        if isinstance(a, (tuple, list)):
            return [read(x) for x in a]
        raise NotImplementedError(f"operand {a!r} in DFG extraction")

    def emit(op: str, args):
        if all(isinstance(a, int) for a in args):
            return b.op("MOVC", const=_const_eval(op, args))
        return b.op(op, *args)

    def constant(node):
        t = gm
        for part in node.target.split("."):
            t = getattr(t, part)
        if not (isinstance(t, torch.Tensor) and t.dim() == 0
                and not t.is_floating_point() and not t.is_complex()):
            raise NotImplementedError(f"constant {node.target} is not an "
                                      f"integer scalar")
        return int(t.item())

    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            env[node.name] = constant(node)
            continue
        if node.op == "output":
            out = read(node.args[0])
            break
        if node.op == "call_method" and node.target in _FX_PASS:
            env[node.name] = read(node.args[0])
            continue
        args = [read(a) for a in node.args]
        kwargs = {k: read(v) for k, v in node.kwargs.items()}
        kind = (targets.get(node.target) if node.op == "call_function"
                else None)
        if kind is None or (kwargs and kind != "clamp"):
            raise NotImplementedError(
                f"{node.op} {getattr(node.target, '__name__', node.target)} "
                f"in DFG extraction")
        if kind == "neg":
            x = args[0]
            res = b.op("SUB", 0, x) if isinstance(x, Ref) else -x
        elif kind == "pow":
            x, y = args
            if not isinstance(y, int) or y < 1:
                raise NotImplementedError(f"x ** {y!r} in DFG extraction: "
                                          f"the exponent must be an int >= 1")
            res = x
            for _ in range(y - 1):
                res = emit("MUL", [res, x])
        elif kind == "where":
            pred, on_true, on_false = args
            res = b.op("SELECT", pred, on_true, on_false)
        elif kind == "clamp":
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            if (lo is None and hi is None) or set(kwargs) - {"min", "max"}:
                raise NotImplementedError(f"clamp{tuple(kwargs)} in DFG "
                                          f"extraction")
            res = args[0]
            if lo is not None:
                res = emit("MAX", [res, lo])
            if hi is not None:
                res = emit("MIN", [res, hi])
        else:
            res = emit(kind, args)
        env[node.name] = res
    outs = out if isinstance(out, list) else [out]
    return [o if isinstance(o, Ref) else b.op("MOVC", const=o) for o in outs]


def _const_eval(op: str, args: List[int]) -> int:
    a = [np.int32(x) for x in args]
    return int(_eval_op(op, a, None))


# ---------------------------------------------------------------------------
# Reference interpreter (test-vector oracle)
# ---------------------------------------------------------------------------

def _eval_op(op: str, vals: List[np.int32], const: Optional[int]) -> np.int32:
    v = list(vals)
    if const is not None:
        v.append(np.int32(const))
    with np.errstate(over="ignore"):
        if op == "ADD":
            return np.int32(v[0] + v[1])
        if op == "SUB":
            return np.int32(v[0] - v[1])
        if op == "MUL":
            return np.int32(v[0] * v[1])
        if op == "SHL":
            return np.int32(v[0] << (np.uint32(v[1]) & np.uint32(31)))
        if op == "SHR":
            return np.int32(v[0] >> (np.uint32(v[1]) & np.uint32(31)))
        if op == "AND":
            return np.int32(v[0] & v[1])
        if op == "OR":
            return np.int32(v[0] | v[1])
        if op == "XOR":
            return np.int32(v[0] ^ v[1])
        if op == "MIN":
            return np.int32(min(v[0], v[1]))
        if op == "MAX":
            return np.int32(max(v[0], v[1]))
        if op == "ABS":
            return np.int32(abs(v[0]))
        if op == "CMPLT":
            return np.int32(v[0] < v[1])
        if op == "CMPGT":
            return np.int32(v[0] > v[1])
        if op == "CMPEQ":
            return np.int32(v[0] == v[1])
        if op == "CMPNE":
            return np.int32(v[0] != v[1])
        if op == "CMPLE":
            return np.int32(v[0] <= v[1])
        if op == "CMPGE":
            return np.int32(v[0] >= v[1])
        if op == "SELECT":
            return np.int32(v[1] if v[0] else v[2])
        if op == "MOVC":
            return np.int32(const)
        if op == "NOP" or op == "ROUTE":
            return v[0] if v else np.int32(0)
    raise ValueError(f"unknown op {op}")


def interpret(dfg: DFG, mem: Dict[str, np.ndarray], n_iters: int
              ) -> Dict[str, np.ndarray]:
    """Execute the DFG for ``n_iters`` loop iterations (the oracle)."""
    mem = {k: v.astype(INT).copy() for k, v in mem.items()}
    for name, ln in dfg.arrays.items():
        if name not in mem:
            mem[name] = np.zeros(ln, INT)
    order = dfg.topo_order()
    hist: Dict[int, List[np.int32]] = {n.id: [] for n in dfg.nodes}
    for i in range(n_iters):
        vals: Dict[int, np.int32] = {}
        for nid in order:
            n = dfg.nodes[nid]
            ops = []
            for o in n.operands:
                if o.dist == 0:
                    ops.append(vals[o.src])
                elif i - o.dist < 0:
                    ops.append(np.int32(o.init))
                else:
                    ops.append(hist[o.src][i - o.dist])
            if n.op == "LOAD":
                idx = (int(ops[0]) if ops else 0) + (n.const or 0)
                vals[nid] = np.int32(mem[n.array][idx])
            elif n.op == "STORE":
                if len(ops) == 2:
                    idx, val = int(ops[0]) + 0, ops[1]
                else:
                    idx, val = 0, ops[0]
                idx += n.const or 0
                mem[n.array][idx] = val
                vals[nid] = val
            else:
                vals[nid] = _eval_op(n.op, ops, n.const)
            hist[nid].append(vals[nid])
    return mem


# ---------------------------------------------------------------------------
# Data layout (paper: round-robin bank allocation, bases folded into nodes)
# ---------------------------------------------------------------------------

@dataclass
class DataLayout:
    bases: Dict[str, int]            # array -> global base word address
    banks: Dict[str, int]            # array -> bank id
    n_banks: int
    bank_words: int

    @property
    def total_words(self) -> int:
        return self.n_banks * self.bank_words


def plan_layout(dfg: DFG, n_banks: int = 4, bank_words: int = 2048) -> DataLayout:
    bases, banks = {}, {}
    fill = [0] * n_banks
    for i, (name, ln) in enumerate(dfg.arrays.items()):
        b = i % n_banks                            # round-robin (paper heuristic)
        if fill[b] + ln > bank_words:
            b = int(np.argmin(fill))
        if fill[b] + ln > bank_words:
            raise ValueError(f"array {name} ({ln}w) does not fit any bank")
        banks[name] = b
        bases[name] = b * bank_words + fill[b]
        fill[b] += ln
    return DataLayout(bases, banks, n_banks, bank_words)


def apply_layout(dfg: DFG, layout: DataLayout) -> DFG:
    """Fold base addresses into LOAD/STORE consts (returns a new DFG)."""
    nodes = []
    for n in dfg.nodes:
        if n.op in MEM_OPS:
            nodes.append(replace(n, const=(n.const or 0) + layout.bases[n.array]))
        else:
            nodes.append(replace(n))
    return DFG(nodes, dict(dfg.arrays), name=dfg.name, outputs=dfg.outputs)


def flat_memory(layout: DataLayout, mem: Dict[str, np.ndarray]) -> np.ndarray:
    flat = np.zeros(layout.total_words, INT)
    for name, base in layout.bases.items():
        arr = mem.get(name)
        if arr is not None:
            flat[base:base + len(arr)] = arr.astype(INT)
    return flat


def unflatten_memory(layout: DataLayout, flat: np.ndarray,
                     arrays: Dict[str, int]) -> Dict[str, np.ndarray]:
    return {name: flat[layout.bases[name]:layout.bases[name] + ln].copy()
            for name, ln in arrays.items()}


def flat_memory_batch(layout: DataLayout,
                      mems: List[Dict[str, np.ndarray]],
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Batched ``flat_memory``: B named-array dicts -> (B, total_words).

    One allocation and one vectorized assignment per *array name* instead
    of a Python loop over samples — the hot path of every natively-batched
    backend.  Samples may still omit arrays (zero-filled) or pass short
    arrays; only such ragged names fall back to a per-sample copy.
    ``out`` (a (B, total_words) int32 array) is zeroed and filled in place
    of a new allocation: the execution engine flattens straight into its
    pinned staging buffer this way.
    """
    B = len(mems)
    if out is None:
        flat = np.zeros((B, layout.total_words), INT)
    else:
        if out.shape != (B, layout.total_words) or out.dtype != INT:
            raise ValueError(f"out must be a ({B}, {layout.total_words}) "
                             f"int32 array, got {out.dtype} {out.shape}")
        flat = out
        flat[...] = 0
    for name, base in layout.bases.items():
        rows = [m.get(name) for m in mems]
        present = [r for r in rows if r is not None]
        if not present:
            continue
        lens = {len(r) for r in present}
        if len(present) == B and len(lens) == 1:
            ln = lens.pop()
            flat[:, base:base + ln] = np.asarray(rows, dtype=INT)
        else:                                    # ragged / missing: per row
            for b, r in enumerate(rows):
                if r is not None:
                    flat[b, base:base + len(r)] = np.asarray(r, dtype=INT)
    return flat


def unflatten_memory_batch(layout: DataLayout, flats: np.ndarray,
                           arrays: Dict[str, int]
                           ) -> List[Dict[str, np.ndarray]]:
    """Batched ``unflatten_memory``: (B, total_words) -> B dicts.

    One contiguous copy per array name; the per-sample dicts share those
    copies as row views (callers treat outputs as read-only snapshots,
    exactly like the scalar path's fresh arrays)."""
    cols = {name: flats[:, layout.bases[name]:layout.bases[name] + ln].copy()
            for name, ln in arrays.items()}
    return [{name: col[b] for name, col in cols.items()}
            for b in range(flats.shape[0])]
