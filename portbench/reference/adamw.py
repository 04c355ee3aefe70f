"""AdamW in plain PyTorch, float32: linear warm-up then cosine decay to a
tenth, the gradient clipped by its global norm, bias-corrected moments,
decoupled weight decay; each new parameter rounded to the dtype the
configuration stores it in."""
from __future__ import annotations

import math

import torch


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(1, o["warmup_steps"]), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(1, o["total_steps"] - o["warmup_steps"]), 0.0), 1.0)
    return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def step(params, grads, m, v, stored, t: int, o: dict) -> float:
    """AdamW step ``t`` (from 1) on lists of f32 tensors, in place;
    ``stored[i]`` is the dtype parameter i is kept in.  Returns the
    gradient's global norm before the clip."""
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = torch.clamp_max(o["grad_clip"] / (gnorm + 1e-9), 1.0)
    b1, b2 = o["betas"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    lr = lr_at(o, t)
    for p, g, mi, vi, dt in zip(params, grads, m, v, stored):
        g = g * scale
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (mi / bc1) / (torch.sqrt(vi / bc2) + o["eps"]) \
            + o["weight_decay"] * p
        p.copy_((p - lr * delta).to(dt).float())
    return float(gnorm)
