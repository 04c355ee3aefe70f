"""Layers shared by the reference models, in float32."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: a norm's scale at the start, a gain of 1 under ``rms_norm``'s
#: (1 + scale) convention
GAIN = ("const", 0.0)


@contextlib.contextmanager
def full_f32():
    """Within the block, float32 products run in float32 (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def matmul(a, b):
    """A weight product (the control replaces it, ``lowp.py``)."""
    return a @ b


def act(x):
    """An activation as the configuration stores it between operations:
    kept in f32 here (the control rounds it, ``lowp.py``)."""
    return x


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` convention."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split.  x: (B, S, H, D), positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, block: int = 2048):
    """Causal softmax attention, scale 1/sqrt(D), in blocks of query rows.
    q: (B, S, H, D); k, v: (B, S, KV, D), H a multiple of KV."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, D)
    outs = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        s = (qt[:, :, s0:s1] / math.sqrt(D)) @ kt[:, :, :s1].transpose(-1, -2)
        keep = (torch.arange(s0, s1, device=q.device)[:, None]
                >= torch.arange(s1, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ vt[:, :, :s1])
    return torch.cat(outs, dim=2).transpose(1, 2)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    grad is on (so that a whole model's backward fits beside its f32
    weights, gradients and moments)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def shift(x):
    """x moved one position later along the sequence, zero first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def lm_loss(logits, targets, z_weight: float = 1e-4):
    """Mean next-token cross-entropy plus the z-loss, in f32."""
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + z_weight * logz.square().mean()
