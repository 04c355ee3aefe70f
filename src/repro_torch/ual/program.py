"""``Program`` — the portable compilation unit of the unified abstraction layer.

A Program bundles everything a CGRA toolchain needs to know about a kernel
*before* any hardware is chosen: the dataflow graph, the planned scratchpad
data layout (bank assignment + base addresses) and a named I/O spec
(array name -> length, plus which arrays are outputs).  It is immutable and
content-hashable: ``Program.digest`` is a stable SHA-256 over the canonical
structure, so identical kernels hash identically across processes — the
mapping cache (see ``ual.cache``) keys on it.

Constructors cover the three frontends:

  * ``Program.from_builder``  — a ``DFGBuilder`` (annotated-kernel DSL),
  * ``Program.from_kernel``   — a ``core.kernel_lib`` entry by name,
  * ``Program.from_function`` — a pure scalar function of torch ops traced
    via ``trace_into`` into an elementwise loop body.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from functools import cached_property
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dfg import (DFG, DataLayout, DFGBuilder, apply_layout,
                                  flat_memory, flat_memory_batch, plan_layout,
                                  trace_into, unflatten_memory,
                                  unflatten_memory_batch)


@dataclass(frozen=True)
class Program:
    dfg: DFG                       # pre-layout DFG over *named* arrays
    layout: DataLayout             # planned scratchpad layout
    n_iters: int = 16              # default trip count (runtime, not hashed)
    make_mem: Optional[Callable[[np.random.Generator],
                                Dict[str, np.ndarray]]] = field(
        default=None, compare=False)   # default test-vector generator

    # -- I/O spec -------------------------------------------------------------
    @property
    def name(self) -> str:
        return self.dfg.name

    @property
    def arrays(self) -> Dict[str, int]:
        return self.dfg.arrays

    @property
    def outputs(self) -> Tuple[str, ...]:
        return self.dfg.outputs

    @property
    def inputs(self) -> Tuple[str, ...]:
        """Arrays the caller provides: everything not declared an output.
        Output arrays (including in/out accumulators) start zero-filled
        unless the caller passes them explicitly."""
        return tuple(n for n in self.dfg.arrays if n not in self.dfg.outputs)

    # -- lowering -------------------------------------------------------------
    @cached_property
    def laid(self) -> DFG:
        """The layout-applied DFG (base addresses folded into LOAD/STOREs)."""
        return apply_layout(self.dfg, self.layout)

    def check_arrays(self, mem: Dict[str, np.ndarray]) -> None:
        """Reject unknown names / oversized arrays (all backends call this,
        so a typo'd input fails identically on interp, sim, torch and cuda)."""
        for name, arr in mem.items():
            if name not in self.arrays:
                raise KeyError(f"{self.name}: unknown array {name!r}; "
                               f"declared: {sorted(self.arrays)}")
            if len(arr) > self.arrays[name]:
                raise ValueError(f"{self.name}: array {name!r} has "
                                 f"{len(arr)} words, declared "
                                 f"{self.arrays[name]}")

    def flatten(self, mem: Dict[str, np.ndarray]) -> np.ndarray:
        """Named arrays -> flat scratchpad image (missing arrays zeroed)."""
        self.check_arrays(mem)
        return flat_memory(self.layout, mem)

    def unflatten(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        return unflatten_memory(self.layout, flat, self.dfg.arrays)

    def flatten_batch(self, mems: Sequence[Dict[str, np.ndarray]],
                      out: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched ``flatten``: B dicts -> (B, total_words) in one
        vectorized pass per array name (no per-sample Python loop) — what
        the natively-batched backends feed the engines.  ``out`` is
        internal: the engine passes its staging buffer's rows to flatten
        into them in place."""
        mems = list(mems)
        for m in mems:
            self.check_arrays(m)
        return flat_memory_batch(self.layout, mems, out)

    def unflatten_batch(self, flats: np.ndarray
                        ) -> "list[Dict[str, np.ndarray]]":
        """Batched ``unflatten``: (B, total_words) -> B named-array dicts
        (one contiguous copy per array name)."""
        return unflatten_memory_batch(self.layout, flats, self.dfg.arrays)

    def random_inputs(self, rng: np.random.Generator,
                      lo: int = -50, hi: int = 50) -> Dict[str, np.ndarray]:
        """Test vectors: ``make_mem`` if the frontend supplied one, else
        uniform random int32 for every non-output array."""
        if self.make_mem is not None:
            return dict(self.make_mem(rng))
        return {n: rng.integers(lo, hi, self.arrays[n]).astype(np.int32)
                for n in self.inputs}

    # -- content hash ---------------------------------------------------------
    @cached_property
    def digest(self) -> str:
        """Stable SHA-256 of the canonical structure (process-independent).

        Covers the DFG (ops, operand edges with recurrence dist/init,
        immediates, array bindings), the I/O spec and the data layout —
        everything that influences mapping.  Excludes ``n_iters`` and
        ``make_mem`` (runtime concerns) and the kernel name.
        """
        nodes = [[n.op, [[o.src, o.dist, o.init] for o in n.operands],
                  n.const, n.array] for n in self.dfg.nodes]
        spec = {
            "nodes": nodes,
            "arrays": sorted(self.dfg.arrays.items()),
            "outputs": list(self.dfg.outputs),
            "layout": {
                "bases": sorted(self.layout.bases.items()),
                "banks": sorted(self.layout.banks.items()),
                "n_banks": self.layout.n_banks,
                "bank_words": self.layout.bank_words,
            },
        }
        blob = json.dumps(spec, separators=(",", ":"), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_dfg(dfg: DFG, n_iters: int = 16, *,
                 make_mem: Optional[Callable] = None,
                 n_banks: int = 4, bank_words: Optional[int] = None
                 ) -> "Program":
        if bank_words is None:
            bank_words = max(2048, max(dfg.arrays.values(), default=0) + 64)
        layout = plan_layout(dfg, n_banks=n_banks, bank_words=bank_words)
        return Program(dfg, layout, n_iters, make_mem)

    @staticmethod
    def from_builder(builder: DFGBuilder, n_iters: int = 16, *,
                     make_mem: Optional[Callable] = None,
                     n_banks: int = 4, bank_words: Optional[int] = None
                     ) -> "Program":
        return Program.from_dfg(builder.build(), n_iters, make_mem=make_mem,
                                n_banks=n_banks, bank_words=bank_words)

    @staticmethod
    def from_kernel(name: str, *, n_banks: int = 4,
                    bank_words: Optional[int] = None) -> "Program":
        """A ``core.kernel_lib`` entry, with its test-vector generator."""
        from repro_torch.core.kernel_lib import KERNELS
        if name not in KERNELS:
            raise KeyError(f"unknown kernel {name!r}; "
                           f"known: {sorted(KERNELS)}")
        dfg, make_mem, n_iters = KERNELS[name]()
        return Program.from_dfg(dfg, n_iters, make_mem=make_mem,
                                n_banks=n_banks, bank_words=bank_words)

    @staticmethod
    def from_function(fn: Callable, inputs: Dict[str, int], *,
                      outputs: Sequence[str] = ("out",),
                      n_iters: Optional[int] = None,
                      name: str = "traced") -> "Program":
        """Trace a pure scalar int32 function into an elementwise loop body.

        ``fn`` takes one scalar per entry of ``inputs`` (in dict order) and
        returns one scalar per entry of ``outputs``; iteration ``i`` applies
        it to element ``i`` of each input array.  ``fn`` is written with
        Python's operators and torch ops (``trace_into``), not ``jnp``.
        """
        b = DFGBuilder(name)
        for arr, ln in inputs.items():
            b.array(arr, ln)
        length = min(inputs.values())
        for arr in outputs:
            b.array(arr, length, output=True)
        i = b.counter()
        vals = [b.load(arr, i) for arr in inputs]
        outs = trace_into(b, fn, vals)
        if len(outs) != len(outputs):
            raise ValueError(f"{name}: fn returned {len(outs)} values for "
                             f"{len(outputs)} declared outputs")
        for arr, v in zip(outputs, outs):
            b.store(arr, i, v)
        return Program.from_builder(b, n_iters if n_iters is not None
                                    else length)
