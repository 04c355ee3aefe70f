"""Per-device cost of a traced step (the JAX package's
``analysis/hlo_cost.py``, whose name it keeps so that a reader finds the
counterpart).

There is no HLO here.  The reference parses the compiled, post-SPMD HLO
text; the port runs the step once on ``meta`` tensors (no memory, no
arithmetic) under ``CostModel``, a ``TorchDispatchMode`` that sees every
ATen op each device runs on its local shards, and every collective
(``_c10d_functional.*``) that ``DTensor`` issues between them.  Each device
of the dry-run's mesh runs the same program, so every quantity is PER
DEVICE, as in the reference:

  * products   -> FLOPs by ``torch.utils.flop_counter``'s rules (mm, bmm,
                  addmm, convolutions: 2 * |output| * contraction)
  * other ops  -> one FLOP per output element (the reference's generic op)
  * bytes      -> each op's inputs read once and outputs written once.
                  These are the eager program's own bytes: no op is fused,
                  so no fusion is credited (the reference counts a fusion's
                  operands and outputs only)
  * collectives -> kind, count and per-device wire bytes with the
                  reference's ring factors over the group's size g:
                  all-gather ob (g-1), reduce-scatter out (g-1),
                  all-reduce 2 ob (g-1)/g, all-to-all ob (g-1)/g,
                  permute ob (``wire_bytes``)

The kernels' plain versions, which the models run on ``meta``, are counted
as one launch of the hand-written kernel each (``kernel``, entered by
``analysis.kernel_cost.as_kernel``): the kernel's least FLOPs and its own
I/O bytes, not the plain ops'.  The rest of the step is the eager program
as it runs on the card.

View ops (which alias their input) and allocations cost nothing.  Ops that
``DTensor`` runs on fake tensors to propagate shapes are not the device's
work and are skipped.  ``peak_temp_bytes`` is the peak of the bytes held by
live op outputs (the counterpart of XLA's temp allocation).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``_c10d_functional`` / ``_dtensor`` op names -> the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
_FREE = {"empty", "empty_strided", "empty_like", "detach", "lift_fresh",
         "alias", "wait_tensor", "_wrap_tensor_autograd"}
_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sin",
                   "cos", "sigmoid", "exp2", "log2", "log1p", "expm1",
                   "logsumexp", "softplus", "_softmax", "_log_softmax"}


def wire_bytes(kind: str, operand_bytes: float, out_bytes: float,
               g: int) -> float:
    """Per-device wire bytes of one collective over a group of ``g``
    (the reference's ring model, ``hlo_cost.py:343-352``)."""
    if kind == "all-gather":
        return operand_bytes * (g - 1)
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (g - 1) / g
    if kind == "all-to-all":
        return operand_bytes * (g - 1) / g
    return operand_bytes                        # collective-permute


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _numel(x) -> int:
    return sum(t.numel() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _shape(x) -> str:
    ts = [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]
    return ", ".join(f"{str(t.dtype).replace('torch.', '')}"
                     f"{list(t.shape)}" for t in ts)[:70]


def _group_size(func, args, kwargs) -> int:
    """The size of the group a functional collective runs over: its
    ``group_size`` argument, else its named group's size."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    return _resolve_process_group(named["group_name"]).size()


class CostModel(TorchDispatchMode):
    """Accumulates the per-device cost of the ops run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.memory: Dict[Tuple[str, str], Dict[str, float]] = {}
        self.collective_ops: Dict[Tuple[str, str, int],
                                  Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self.inside = 0
        self.kernels: Dict[str, int] = {}

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float):
        """The ops run in the block are one launch of kernel ``name``, of
        ``flops`` product FLOPs and ``nbytes`` bytes: they are not counted
        one by one, and the tensors appended to the yielded list are its
        outputs (held as live memory)."""
        held: list = []
        self.inside += 1
        try:
            yield held
        finally:
            self.inside -= 1
        self.flops += flops
        self.product_flops += flops
        self.bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1
        m = self.memory.setdefault((name, _shape(held)),
                                   {"count": 0.0, "bytes": 0.0})
        m["count"] += 1
        m["bytes"] += nbytes
        self._hold(held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor lower the op to local ops and collectives first
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(isinstance(a, FakeTensor)
                   for a in tree_leaves((args, kwargs))):
            self._record(func, args, kwargs, out)
        return out

    def _hold(self, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                n = t.numel() * t.element_size()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _record(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if self.inside or func.is_view or name in _FREE:
            return
        ob, out_b = _nbytes((args, kwargs)), _nbytes(out)
        if ns in ("_c10d_functional", "_dtensor", "c10d") and name in _KINDS:
            kind = _KINDS[name]
            g = _group_size(func, args, kwargs)
            wire = wire_bytes(kind, ob, out_b, g)
            d = self.coll.setdefault(kind, {"count": 0.0,
                                            "operand_bytes": 0.0,
                                            "wire_bytes": 0.0})
            d["count"] += 1
            d["operand_bytes"] += ob
            d["wire_bytes"] += wire
            c = self.collective_ops.setdefault(
                (kind, _shape(out), g), {"count": 0.0, "wire_bytes": 0.0})
            c["count"] += 1
            c["wire_bytes"] += wire
        else:
            packet = func.overloadpacket
            if packet in flop_registry:
                n = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += n
                self.product_flops += n
            else:
                self.flops += _numel(out)
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += _numel(out)
        self.bytes += ob + out_b
        m = self.memory.setdefault((name, _shape(out)),
                                   {"count": 0.0, "bytes": 0.0})
        m["count"] += 1
        m["bytes"] += ob + out_b
        if not name.endswith("_"):           # in place: no new buffer
            self._hold(out)

    def result(self) -> Dict[str, object]:
        """``analyze_hlo``'s keys, and the two profiles for the CLIs."""
        return {
            "flops_per_device": self.flops,
            "product_flops_per_device": self.product_flops,
            "bytes_per_device": self.bytes,
            "transcendentals_per_device": self.transcendentals,
            "collective_wire_bytes_per_device": sum(
                v["wire_bytes"] for v in self.coll.values()),
            "collective_operand_bytes_per_device": sum(
                v["operand_bytes"] for v in self.coll.values()),
            "collectives": {k: dict(v) for k, v in self.coll.items()},
            "peak_temp_bytes": self.peak,
            "kernel_launches": dict(self.kernels),
            "top_memory": dict(self.memory),
            "top_collectives": dict(self.collective_ops),
        }


__all__: List[str] = ["COLLECTIVES", "CostModel", "wire_bytes"]
