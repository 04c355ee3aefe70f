"""Activation-sharding context: lets the (sharding-agnostic) model code name
the layouts that the step builders configure (the JAX package's
``sharding/ctx.py``, in PyTorch).

The sharded steps run the models on ``DTensor``s.  Left to itself,
``DTensor``'s sharding propagation may pick layouts the plan does not want
(e.g. replicating the batch dim and sharding d_model across the FSDP
axis); constraining ``hidden`` / ``logits`` / expert buffers pins the
intended DP x TP program.  ``constrain(x, kind)`` is the reference's
``with_sharding_constraint``: with no rules set, or on a plain tensor (an
unsharded step), it returns ``x`` as it is, at the cost of one context
variable read; on a ``DTensor`` under rules it redistributes ``x`` to the
rule's placements, and a rule that cannot be applied raises.  Where a
rule's mesh axes do not divide a dimension, XLA pads it; here the axes stay
off that dimension (as ``sanitize_specs`` does for parameters), and every
such drop is said: a ``ShardingDropWarning``, and an entry in the list of
``record_drops`` (the dry-run's record keeps it).

``local_placements`` gives the per-device kernels (flash attention, the
SSD, the WKV) their layouts from the same rules: each runs on its local
shards through ``torch.distributed.tensor.experimental.local_map``.
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Dict, List, Optional

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.specs import (NamedSharding, P, dp_axes, fitted,
                                        mesh_axis)
from repro_torch.sharding.specs import placements as placements_of

_RULES: contextvars.ContextVar[Optional[Dict[str, NamedSharding]]] = \
    contextvars.ContextVar("activation_rules", default=None)
#: the lists ``record_drops`` fills (a plain global, not a context
#: variable: a rematerialized layer's forward runs again on autograd's
#: thread)
_DROP_LOGS: List[list] = []


class ShardingDropWarning(UserWarning):
    """A rule's mesh axis left off a dimension it does not divide."""


@contextlib.contextmanager
def record_drops():
    """Yields a list that collects every axis a rule leaves off a
    dimension in the block: dicts of ``rule``, ``spec``, ``shape`` and the
    spec ``applied``, one per distinct drop, with its ``count``."""
    log: list = []
    _DROP_LOGS.append(log)
    try:
        yield log
    finally:
        _DROP_LOGS.remove(log)


def note_drop(rule: str, spec, shape, applied) -> None:
    """Say that rule ``rule``'s ``spec`` was applied as ``applied`` on a
    tensor of ``shape`` (a warning, and an entry in each active
    ``record_drops`` list)."""
    entry = {"rule": rule, "spec": str(spec), "shape": list(shape),
             "applied": str(applied)}
    warnings.warn(f"sharding rule {rule!r} {spec} on shape {tuple(shape)} "
                  f"applied as {applied}: its axes do not divide the "
                  f"dimension (XLA would pad it)", ShardingDropWarning,
                  stacklevel=4)
    for log in _DROP_LOGS:
        for seen in log:
            if all(seen[k] == v for k, v in entry.items()):
                seen["count"] += 1
                break
        else:
            log.append({**entry, "count": 1})


def fit(rule: str, spec: P, shape, mesh: Mesh) -> P:
    """``specs.fitted(spec, shape, mesh)``, each axis it leaves off a
    dimension said (``note_drop``)."""
    applied = fitted(spec, shape, mesh)
    whole = P(*(list(spec) + [None] * (len(shape) - len(spec))))
    if tuple(applied) != tuple(whole):
        note_drop(rule, whole, shape, applied)
    return applied


def make_rules(mesh: Mesh, batch_sharded: bool = True,
               strategy: str = "tp2d",
               kv_tp_ok: bool = True) -> Dict[str, NamedSharding]:
    dp = dp_axes(mesh, strategy)
    tp = mesh_axis(mesh, "model") if strategy != "fsdp" else None
    if batch_sharded:
        hidden = P(dp, None, None)
        tokens2d = P(dp, None)
        logits = P(dp, None, tp)
        qkv = P(dp, None, tp, None)
    else:                       # sequence-parallel fallback (batch too small)
        hidden = P(None, dp, None)
        tokens2d = P(dp, None)          # flattened tokens still shard dim 0
        logits = P(None, dp, tp)
        qkv = P(None, dp, tp, None)
    rules = {
        "hidden": hidden,
        "logits": logits,
        "qkv": qkv,
        "tokens2d": tokens2d,
        "expert_buf": P(tp, None, None),       # (E, C, d): experts over TP
        "expert_hidden": P(tp, None, None),    # (E, C, f)
        # grouped (GShard-style) dispatch: groups align with the DP shards,
        # experts with TP
        "moe_tokens_g": P(dp, None, None),     # (G, Tl, d)
        "expert_buf_g": P(dp, tp, None, None),     # (G, E, C, d)
        "expert_hidden_g": P(dp, tp, None, None),  # (G, E, C, f)
        # whole-head attention sharding: q heads over TP; kv heads
        # replicate when kv_heads % tp != 0 so scores never reduce across
        # devices
        "moe_gathered": P(dp, None, None, tp),     # (G, Tl, k, d/tp)
        "q_heads": P(dp if batch_sharded else None, None, tp, None),
        "kv_heads": P(dp if batch_sharded else None, None,
                      tp if kv_tp_ok else None, None),
    }
    return {k: NamedSharding(mesh, v) for k, v in rules.items()}


@contextlib.contextmanager
def activation_sharding(rules: Optional[Dict[str, NamedSharding]]):
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def sharded(fn, rules):
    """``fn`` run under ``rules``, with plain tensors read as replicated
    ``DTensor``s (``implicit_replication``: positions, masks, zeros the
    model makes on every device alike): a sharded step's body."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with activation_sharding(rules), implicit_replication():
            return fn(*args)
    return run


def current_rules() -> Optional[Dict[str, NamedSharding]]:
    return _RULES.get()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a sharded step's tensor)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, kind: str):
    """``x`` redistributed to rule ``kind``'s placements when rules are set
    and ``x`` is a ``DTensor``; else ``x`` itself.  As ``sanitize_specs``
    does for parameters, a rule's axes stay off a dim they do not divide
    (batch 1's sequence of one token under the sequence-parallel rules,
    hubert's 504 logits over 16 devices), where XLA would pad; each such
    drop is said (``fit``).  Raises on a rule whose rank differs from
    ``x``'s, or on a kind the rules do not have."""
    rules = _RULES.get()
    if rules is None or not is_dtensor(x):
        return x
    if kind not in rules:
        raise KeyError(f"no activation rule {kind!r}; have {sorted(rules)}")
    sh = rules[kind]
    if x.ndim != len(sh.spec):
        raise ValueError(f"rule {kind!r} {sh.spec} is for rank "
                         f"{len(sh.spec)}, the tensor has shape "
                         f"{tuple(x.shape)}")
    placements = placements_of(fit(kind, sh.spec, x.shape, sh.mesh),
                               sh.mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_offset(n: int, mesh, placements, dim: int) -> int:
    """The first index along tensor dim ``dim`` (of size ``n``) that this
    rank's shard holds under ``placements`` (``torch.chunk``'s split, mesh
    dims in order)."""
    offset, size = 0, n
    for m, pl in enumerate(placements):
        if pl.is_shard(dim):
            chunk = -(-size // mesh.size(m))
            c = mesh.get_local_rank(m)
            offset += min(c * chunk, size)
            size = max(0, min(chunk, size - c * chunk))
    return offset


def like(src, dst):
    """``src`` laid out as ``dst``: a ``DTensor`` redistributed to ``dst``'s
    placements (for an in-place copy into ``dst``); else ``src`` itself."""
    placements = getattr(dst, "placements", None)
    if placements is None or tuple(src.placements) == tuple(placements):
        return src
    return src.redistribute(dst.device_mesh, placements)


def per_device(fn, out_placements, in_placements, mesh):
    """``local_map`` of ``fn`` over ``mesh`` (inputs redistributed to
    ``in_placements``), with each input's gradient laid out as the local
    work makes it.  On a mesh dim where an input is whole (``Replicate``)
    but the outputs differ from device to device (``Shard``, ``Partial``),
    each device's gradient of that input is its part of a sum
    (``Partial``): a weight read by each device's batch rows, kv heads
    picked by each device's q heads, B and C shared by each device's
    heads.  Elsewhere the gradient takes the input's own placement.  So on
    such a dim every output must carry only its device's part of the work:
    a statistic that every device computes alike would be summed once per
    device."""
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map

    single = len(out_placements) > 0 and isinstance(out_placements[0],
                                                    Placement)
    outs = [out_placements] if single else [o for o in out_placements
                                            if o is not None]
    differs = [any(not o[m].is_replicate() for o in outs)
               for m in range(mesh.ndim)]
    grads = tuple(None if pl is None else tuple(
        Partial() if differs[m] and p.is_replicate() else p
        for m, p in enumerate(pl)) for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)


def local_placements(kind: str, shape) -> tuple:
    """Placements of a per-device kernel operand of ``shape`` laid out like
    rule ``kind`` (``q_heads``: (B, S, heads, width), batch over DP when
    the batch shards, heads over TP), keeping its first ``len(shape)``
    entries; ``"heads"`` is a (heads, ...) operand (``A_log``, ``D``,
    ``u``) and ``"batch"`` a (B, S, N) one (the SSD's B and C, shared by
    every head).  Axes stay off a dim they do not divide (a microbatch
    smaller than the DP axis, 8 heads over 16 devices), each drop said
    (``fit``).  Raises when no rules are set: a ``DTensor`` reached a
    kernel outside a sharded step."""
    rules = _RULES.get()
    if rules is None:
        raise RuntimeError("a DTensor reached a per-device kernel with no "
                           "activation rules set (run it inside a sharded "
                           "step)")
    q = rules["q_heads"]
    rank = len(shape)
    if kind == "heads":
        spec = P(q.spec[2], *([None] * (rank - 1)))
    elif kind == "batch":
        spec = P(q.spec[0], *([None] * (rank - 1)))
    else:
        spec = P(*rules[kind].spec[:rank])
    return placements_of(fit(kind, spec, shape, q.mesh), q.mesh)


__all__ = ("ShardingDropWarning", "activation_sharding", "constrain",
           "current_rules", "fit", "is_dtensor", "like", "local_placements",
           "make_rules", "note_drop", "per_device", "record_drops",
           "shard_offset", "sharded")
