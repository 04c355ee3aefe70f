"""Mixture-of-Experts layers: DeepSeek-MoE (fine-grained, shared experts)
and Arctic (many-expert top-2 + dense residual) — the JAX package's
``models/moe.py``, in PyTorch.

Dispatch is capacity-based (tokens beyond an expert's capacity are dropped,
their residual passes through) using the sort-free cumsum formulation:
position-in-expert comes from an integer prefix sum of the routing
one-hots, tokens scatter (``index_add_``) into (E * C, d) buffers, experts
run as one batched product, and results gather back with the routing
weights.  Every slot lies in [0, E C) and at most one kept token lands in
each, while a dropped token adds zeros to its expert's last slot, so the
scatter is exact in any order.  The reference computes all of it outside
any Pallas kernel; here it is plain tensor code, on the card as on the CPU.

In a sharded step (``DTensor``s under activation rules) the dispatch runs
per device through ``local_map``, in the expert-parallel layout of the
rules ``moe_tokens_g`` and ``expert_buf_g`` (``expert_buf`` ungrouped):
each device routes its data shard's groups over every expert, fills and
runs only the buffers of its own experts (experts over the model axis), and
the devices' partial outputs are summed across that axis.  The reference's
constraints on the expert buffers sit at its places; inside the local
dispatch they see plain tensors and pass them through.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp, silu
from repro_torch.sharding.ctx import (constrain, current_rules, is_dtensor,
                                      note_drop, per_device)
from repro_torch.sharding.specs import P


def router_topk(logits, k: int, renorm: bool = True):
    """Top-k routing weights.  logits: (T, E) float32."""
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, k, dim=-1)                # (T, k)
    if renorm:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return w, idx


def aux_load_balance_loss(logits, idx, n_experts: int):
    """Switch-style load-balance auxiliary loss."""
    gates = torch.softmax(logits, dim=-1)
    me = gates.mean(0)                                   # mean gate per expert
    onehot = F.one_hot(idx[..., 0], n_experts).to(gates.dtype)
    ce = onehot.mean(0)                                  # fraction routed (top-1)
    return n_experts * torch.sum(me * ce)


def expert_capacity(tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert for ``tokens`` routed tokens."""
    return max(1, int(math.ceil(capacity_factor * top_k * tokens / n_experts)))


class Routing(NamedTuple):
    """One dispatch's routing over G groups of Tl tokens: ``logits`` (G Tl,
    E) f32, ``weights`` and ``idx`` (G, Tl, k), ``keep`` (G, Tl, k) whether
    the (token, choice) fits its expert's capacity ``C``, and ``slot`` (G,
    Tl, k) its row in the group's (E C, d) buffer."""
    logits: torch.Tensor
    weights: torch.Tensor
    idx: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    C: int


def route(xg, router_w, top_k: int, C: int) -> Routing:
    """Route token groups xg (G, Tl, d) with router (d, E) at capacity C;
    the position of a (token, choice) within its expert is the integer
    prefix sum of the routing one-hots over the group's flattened
    (token, choice) order.  The one-hots are laid out (G, E, Tl k), so the
    sum runs along the innermost axis: on the card a scan along an outer
    axis of the (G, Tl k, E) layout took 4.7 ms a layer at deepseek-moe's
    prefill (PERF.md)."""
    G, Tl, _ = xg.shape
    E = router_w.shape[-1]
    logits = (xg.float() @ router_w.float()).reshape(G * Tl, E)
    weights, idx = router_topk(logits, top_k)
    weights = weights.reshape(G, Tl, top_k)
    idx = idx.reshape(G, Tl, top_k)
    flat_idx = idx.reshape(G, 1, Tl * top_k)
    onehot = (torch.arange(E, device=xg.device)[None, :, None]
              == flat_idx).to(torch.int32)                  # (G, E, Tl k)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    pos_in_e = pos.gather(1, flat_idx).reshape(G, Tl, top_k)
    keep = pos_in_e < C
    slot = idx * C + torch.clamp_max(pos_in_e, C - 1)       # in [0, E*C)
    return Routing(logits, weights, idx, keep, slot, C)


def _experts(xg, r: Routing, w_gate, w_up, w_down, *, e0: int, act: str,
             grouped: bool):
    """The routed experts e0 .. e0 + El - 1 (``w_*`` hold El experts) over
    token groups xg (G, Tl, d): scatter the kept (token, choice) pairs
    routed to them into (G, El, C, d) buffers, run the experts as one
    batched product, gather back with the routing weights.  Returns
    (G, Tl, d), the sum over those experts' choices."""
    G, Tl, d = xg.shape
    El, C, top_k = w_gate.shape[0], r.C, r.idx.shape[-1]
    mine = r.keep & (r.idx >= e0) & (r.idx < e0 + El)
    buf_kind = "expert_buf_g" if grouped else "expert_buf"
    hidden_kind = "expert_hidden_g" if grouped else "expert_hidden"

    # scatter tokens into expert buffers (dropped tokens contribute nothing)
    upd = torch.where(mine[..., None], xg[:, :, None, :],
                      torch.zeros((), dtype=xg.dtype, device=xg.device))
    slot = torch.where(mine, r.slot - e0 * C, 0)
    rows = slot + El * C * torch.arange(G, device=xg.device)[:, None, None]
    buf = torch.zeros((G * El * C, d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, rows.reshape(-1), upd.reshape(-1, d))
    buf = constrain(buf.reshape(G, El, C, d), buf_kind)

    # batched expert MLP
    if act == "silu":
        h = silu(torch.einsum("gecd,edf->gecf", buf, w_gate))
        h = h * torch.einsum("gecd,edf->gecf", buf, w_up)
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", buf, w_up),
                   approximate="tanh")
    h = constrain(h, hidden_kind)
    out_buf = constrain(torch.einsum("gecf,efd->gecd", h, w_down),
                        buf_kind).reshape(G * El * C, d)

    # gather back with routing weights
    gathered = out_buf[rows.reshape(-1)].reshape(G, Tl, top_k, d)
    wk = torch.where(mine, r.weights, 0.0).to(xg.dtype)
    return torch.einsum("gtk,gtkd->gtd", wk, gathered)


def _dispatch(xg, w_gate, w_up, w_down, router_w, *, top_k: int, C: int,
              act: str, grouped: bool = False):
    """Capacity-based MoE over token groups xg (G, Tl, d), each group with
    its own prefix sum and buffers.  Returns (out (G, Tl, d), aux)."""
    if is_dtensor(xg):
        return _sharded_dispatch(xg, w_gate, w_up, w_down, router_w,
                                 top_k=top_k, C=C, act=act, grouped=grouped)
    G, Tl, d = xg.shape
    E = w_gate.shape[0]
    r = route(xg, router_w, top_k, C)
    out = _experts(xg, r, w_gate, w_up, w_down, e0=0, act=act,
                   grouped=grouped)
    aux = aux_load_balance_loss(r.logits, r.idx.reshape(G * Tl, top_k), E)
    return out, aux


def _sharded_dispatch(xg, w_gate, w_up, w_down, router_w, *, top_k: int,
                      C: int, act: str, grouped: bool):
    """``_dispatch`` on DTensors, per device (``local_map``): groups over
    the DP axes of ``moe_tokens_g`` where they divide them (else every
    device routes every group), experts over the model axis of
    ``expert_buf_g``'s expert entry where it divides them (each drop said,
    ``note_drop``).  Each device
    routes its groups over all experts, runs its own experts, and returns
    its partial output (summed over the expert axis) with the gate sums and
    top-1 counts over its tokens, from which the load-balance loss is
    formed on the whole batch.  The devices of the expert axis route the
    same tokens alike, so each returns its share (1 / their count) of those
    statistics, summed over the axis: every output then holds only its
    device's part, and the router's gradient through the loss is summed
    once (``per_device``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rules = current_rules()
    mesh = xg.device_mesh
    names = mesh.mesh_dim_names
    G, Tl, _ = xg.shape
    E = w_gate.shape[0]

    def axes(entry):
        return (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))

    def kept_axes(rule, entry, n, dim, shape):
        """The axes of ``entry`` if they divide ``n``; else none, said."""
        got = axes(entry)
        if n % math.prod(mesh.size(names.index(a)) for a in got) == 0:
            return got
        spec = [None] * len(shape)
        spec[dim] = entry
        note_drop(rule, P(*spec), shape, P())
        return ()
    dp = kept_axes("moe_tokens_g", rules["moe_tokens_g"].spec[0], G, 0,
                   xg.shape)
    ep = kept_axes("expert_buf_g", rules["expert_buf_g"].spec[1], E, 1,
                   (G, E, C, xg.shape[-1]))
    x_pl = tuple(Shard(0) if a in dp else Replicate() for a in names)
    w_pl = tuple(Shard(0) if a in ep else Replicate() for a in names)
    out_pl = tuple(Shard(0) if a in dp else Partial() if a in ep
                   else Replicate() for a in names)
    stat_pl = tuple(Partial() if a in dp or a in ep else Replicate()
                    for a in names)
    n_ep = math.prod(mesh.size(names.index(a)) for a in ep)
    El = E // n_ep
    e0 = 0
    for a in ep:
        m = names.index(a)
        e0 = e0 * mesh.size(m) + mesh.get_local_rank(m)
    e0 *= El

    def local(xl, wg, wu, wd, rw):
        r = route(xl, rw, top_k, C)
        out = _experts(xl, r, wg, wu, wd, e0=e0, act=act, grouped=grouped)
        gate_sum = torch.softmax(r.logits, dim=-1).sum(0)
        top1 = torch.zeros_like(gate_sum).index_add_(
            0, r.idx[..., 0].reshape(-1),
            torch.ones(r.idx[..., 0].numel(), dtype=gate_sum.dtype,
                       device=gate_sum.device))
        return out, gate_sum / n_ep, top1 / n_ep

    out, gate_sum, top1 = per_device(
        local, (out_pl, stat_pl, stat_pl),
        (x_pl, w_pl, w_pl, w_pl, tuple(Replicate() for _ in names)),
        mesh)(xg, w_gate, w_up, w_down, router_w)
    T = G * Tl
    aux = E * torch.sum((gate_sum / T) * (top1 / T))
    return out, aux


def moe_dispatch_combine(x, w_gate, w_up, w_down, router_w, *, top_k: int,
                         capacity_factor: float, act: str = "silu",
                         capacity: Optional[int] = None):
    """Capacity-based MoE layer over flattened tokens.

    x: (T, d); expert weights: (E, d, f)/(E, f, d); router_w: (d, E).
    Returns (out (T, d), aux_loss scalar).  ``capacity``: a fixed C in
    place of the factor's.
    """
    C = capacity or expert_capacity(x.shape[0], w_gate.shape[0], top_k,
                                    capacity_factor)
    out, aux = _dispatch(x[None], w_gate, w_up, w_down, router_w,
                         top_k=top_k, C=C, act=act)
    return constrain(out[0], "tokens2d"), aux


def moe_dispatch_combine_grouped(x, w_gate, w_up, w_down, router_w, *,
                                 top_k: int, capacity_factor: float,
                                 groups: int, act: str = "silu"):
    """GShard-style locally-grouped dispatch (the EP all-to-all form).

    Tokens are split into ``groups``; the position-in-expert prefix sum is
    LOCAL to a group, and per-group capacity keeps the total capacity
    identical to the global formulation.
    """
    T, d = x.shape
    Tl = T // groups
    C = expert_capacity(Tl, w_gate.shape[0], top_k, capacity_factor)
    xg = constrain(x.reshape(groups, Tl, d), "moe_tokens_g")
    out, aux = _dispatch(xg, w_gate, w_up, w_down, router_w, top_k=top_k,
                         C=C, act=act, grouped=True)
    return constrain(out, "moe_tokens_g").reshape(T, d), aux


def moe_block(x, p, cfg):
    """Full MoE sub-block for one layer's weights.

    x: (B, S, d) -> (out, aux_loss)
    """
    B, S, d = x.shape
    xf = constrain(x.reshape(B * S, d), "tokens2d")
    groups = cfg.moe_groups or 1
    if groups > 1 and (B * S) % groups == 0:
        out, aux = moe_dispatch_combine_grouped(
            xf, p["we_gate"], p["we_up"], p["we_down"], p["router"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            groups=groups, act=cfg.mlp_act)
    else:
        out, aux = moe_dispatch_combine(
            xf, p["we_gate"], p["we_up"], p["we_down"], p["router"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.mlp_act)
    if cfg.n_shared_experts:
        h = silu(xf @ p["ws_gate"]) * (xf @ p["ws_up"])
        out = out + h @ p["ws_down"]
    if cfg.dense_residual:
        out = out + mlp(xf, p["dense"], cfg.mlp_act)
    return out.reshape(B, S, d), aux
