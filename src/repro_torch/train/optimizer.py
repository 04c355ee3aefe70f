"""AdamW and a factored-second-moment variant (the JAX package's
``train/optimizer.py``, in PyTorch).

The optimizer state is kept in the reference's layout: ``{"step": int32,
"state": tree}``, where ``tree`` mirrors the reference's parameter tree,
each per-layer weight stacked on a leading ``(L, ...)`` axis
(``interop.map_lm_tree`` names each tensor of the port's per-layer lists by
its place there), each leaf holding ``{"m", "v"}`` or, factored,
``{"m", "v_row", "v_col"}``.  That layout decides the factoring exactly as
the reference's does: a per-layer norm of shape ``(d,)`` is a stacked
``(L, d)`` leaf, factored into ``v_row`` (L,) and ``v_col`` (d,), so its
second moment couples the layers, as in the reference.  The state needs no
conversion to cross to the reference's checkpoints.

Everything is f32, as in the reference: the step, the bias corrections
``1 - b^step``, the learning rate and the clip scale are f32 tensors on the
parameters' device.  ``adamw_update`` updates the parameters and the state
in place (the reference returns new trees): on one card the AdamW state of a
1.75 B-parameter model is 14 GB, and a second copy would not be free.
Under a sharded step every tensor here is a ``DTensor``: the state takes
the parameters' specs (``opt_state_specs``, per leaf of the reference's
layout), and each in-place update is laid out as its target first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.interop import at_path, lm_groups, lm_leaves, nest
from repro_torch.sharding.ctx import like
from repro_torch.sharding.specs import P, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    factored: bool = False           # Adafactor-style second moment
    state_dtype: Any = torch.float32


def lr_schedule(opt: OptConfig, step):
    """Linear warm-up, then cosine decay to a tenth, in f32 (``step`` an int
    or a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(1, opt.warmup_steps), 1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(1, opt.total_steps - opt.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return opt.lr * warm * (0.1 + 0.9 * cos)


def _factored_shape(shape):
    """Row/col shapes for factored second moment (last two dims)."""
    if len(shape) < 2:
        return None
    return shape[:-1], shape[:-2] + shape[-1:]


def _stacked_shape(entries) -> Tuple[int, ...]:
    layer, t = entries[0]
    return tuple(t.shape) if layer is None else (len(entries), *t.shape)


def stacked_zeros(params, dtype=torch.float32) -> Dict[str, Any]:
    """Zeros in the reference's layout of ``params``, on their device."""
    return nest({path: torch.zeros(_stacked_shape(e), dtype=dtype,
                                   device=e[0][1].device)
                 for path, e in lm_groups(params).items()})


def init_opt_state(params, opt: OptConfig):
    def init_leaf(entries):
        shape, device = _stacked_shape(entries), entries[0][1].device
        st = {"m": torch.zeros(shape, dtype=opt.state_dtype, device=device)}
        fs = _factored_shape(shape) if opt.factored else None
        if fs is not None:
            st["v_row"] = torch.zeros(fs[0], dtype=opt.state_dtype,
                                      device=device)
            st["v_col"] = torch.zeros(fs[1], dtype=opt.state_dtype,
                                      device=device)
        else:
            st["v"] = torch.zeros(shape, dtype=opt.state_dtype, device=device)
        return st
    device = next(iter(lm_leaves(params)))[2].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "state": nest({path: init_leaf(e)
                           for path, e in lm_groups(params).items()})}


def opt_state_specs(param_specs, opt: OptConfig, abstract_params=None):
    """Specs of the optimizer state, mirroring the params' (both in the
    reference's layout).

    ``abstract_params`` (the same tree of shaped leaves, ``input_specs.
    param_structs``) decides *per leaf* whether the second moment is
    factored — it must match ``init_opt_state``'s shape-based decision
    exactly (a stacked per-layer norm is factored, an unstacked 1-D leaf
    keeps a dense ``v`` even under a factored optimizer).
    """
    def leaf(spec, p):
        st = {"m": spec}
        factored = (opt.factored and p is not None
                    and _factored_shape(tuple(p.shape)) is not None)
        if factored:
            # pad the spec to full rank, then drop the reduced dim:
            # v_row reduces the last dim, v_col the second-to-last
            e = list(spec) + [None] * (len(p.shape) - len(spec))
            st["v_row"] = P(*e[:-1])
            st["v_col"] = P(*(e[:-2] + e[-1:]))
        else:
            st["v"] = spec
        return st

    if abstract_params is None:
        if opt.factored:
            raise ValueError("factored opt_state_specs needs abstract_params")
        abstract_params = tree_map(lambda s: None, param_specs)
    specs = tree_map(leaf, param_specs, abstract_params)
    return {"step": P(), "state": specs}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for _, _, t in lm_leaves(tree)))


def adamw_update(params, grads, opt_state, opt: OptConfig):
    """One AdamW (or factored) update.  Returns (params, opt_state, metrics).

    ``params`` and the moments of ``opt_state`` are updated in place and
    returned; ``grads`` mirrors ``params``.  Each reference leaf is updated
    one layer at a time where the arithmetic allows (every dense leaf, and
    a factored leaf whose per-layer weight has two or more axes), and whole
    where the factored moment couples the layers (a per-layer vector)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(opt.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_schedule(opt, step)
    b1, b2 = opt.betas
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, stepf), 1 - torch.pow(b2, stepf)

    def upd(p, g, st):
        """The reference's ``upd`` on one leaf (or one layer of it):
        updates ``st`` in place and returns the new parameter values."""
        g = g.float() * scale
        m = b1 * st["m"].float() + (1 - b1) * g
        if "v" in st:
            v = b2 * st["v"].float() + (1 - b2) * torch.square(g)
            denom = torch.sqrt(v / bc2) + opt.eps
            st["v"].copy_(like(v, st["v"]))
        else:
            g2 = torch.square(g)
            v_row = b2 * st["v_row"].float() + (1 - b2) * g2.mean(-1)
            v_col = b2 * st["v_col"].float() + (1 - b2) * g2.mean(-2)
            r, c = v_row / bc2, v_col / bc2
            v_hat = (r[..., None] * c[..., None, :]
                     / torch.clamp_min(r.mean(-1)[..., None, None], 1e-30))
            denom = torch.sqrt(v_hat) + opt.eps
            st["v_row"].copy_(like(v_row, st["v_row"]))
            st["v_col"].copy_(like(v_col, st["v_col"]))
        st["m"].copy_(like(m, st["m"]))
        delta = (m / bc1) / denom + opt.weight_decay * p.float()
        return like((p.float() - lr * delta).to(p.dtype), p)

    g_groups = lm_groups(grads)
    with torch.no_grad():
        for path, entries in lm_groups(params).items():
            st = at_path(opt_state["state"], path)
            gs = [g for _, g in g_groups[path]]
            if entries[0][0] is None:
                p = entries[0][1]
                p.copy_(upd(p, gs[0], st))
            elif "v" in st or entries[0][1].dim() >= 2:
                for (i, p), g in zip(entries, gs):
                    p.copy_(upd(p, g, {k: t[i] for k, t in st.items()}))
            else:                      # a factored stack of vectors
                ps = [p for _, p in entries]
                new = upd(torch.stack(ps), torch.stack(gs), st)
                for i, p in enumerate(ps):
                    p.copy_(like(new[i], p))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


__all__ = ("OptConfig", "adamw_update", "global_norm", "init_opt_state",
           "lr_schedule", "opt_state_specs", "stacked_zeros")
