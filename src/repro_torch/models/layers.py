"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full / sliding
window / prefix-LM), gated MLPs (the JAX package's ``models/layers.py``, in
PyTorch).

``blockwise_attention`` is the plain version: an online softmax over KV
blocks, as in the reference.  ``attention_block`` sends prefill attention on
a CUDA tensor to the hand-written flash-attention kernel
(``kernels/flash_attention``) and everything on the CPU to the plain
version; the choice follows the tensor's device, never a failure.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30
#: "window" that never masks anything
GLOBAL_WINDOW = 1 << 30


def _needs_grad(x) -> bool:
    """Whether autograd records what is computed from ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` convention, computed in f32.  Under
    grad, x is read through a second cast, as the reference writes it, so
    that in bf16 x's gradient takes the reference's two roundings (one a
    cast); without grad one cast gives the same values."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (x.float() if _needs_grad(x) else xf) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding, half-split.  x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs      # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sigmoid(x):
    """1 / (1 + exp(-x)) with every step rounded to x's dtype: what the
    reference's ``jax.nn.sigmoid`` computes in bf16 (XLA lowers it to
    negate, exp, add 1 and divide, each rounded).  ``torch.sigmoid`` rounds
    once and differs from it by one bf16 ulp in about a third of the values
    of a normal draw; this form differs in none."""
    return torch.reciprocal(torch.exp(-x) + 1)


class _SiLU(torch.autograd.Function):
    """x * s with s = ``sigmoid(x)``; the gradient as the reference's
    autodiff rounds it, each step in x's dtype: g s + (g x) (s (1 - s))
    (the transpose of silu's tangent t s + x (t s (1 - s)), logistic's
    derivative written as ans (1 - ans))."""

    @staticmethod
    def forward(ctx, x):
        s = sigmoid(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x):
    """x * sigmoid(x) with the sigmoid written out (``sigmoid``), what the
    reference's ``jax.nn.silu`` computes in bf16.  ``F.silu`` rounds once;
    in bf16 that alone moves the logits of the 4-layer zamba2 smoke model
    0.1-0.2 from the reference's, beyond its 5e-2 (the conv and the gate
    each take a silu in every layer).  Its gradient rounds where the
    reference's does (``_SiLU``); autograd of the written-out steps would
    round at others, which moved zamba2's and the dense models' bf16
    gradients away from the reference's.  Without grad, the same steps with
    no Function around them."""
    return _SiLU.apply(x) if _needs_grad(x) else x * sigmoid(x)


def gelu(x):
    """The tanh gelu as the reference's ``jax.nn.gelu`` computes it: x *
    (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))) with its constants
    and every step in x's dtype.  ``F.gelu(approximate="tanh")`` rounds
    once, and in bf16 differs from the reference in a fifth of the values
    of a normal draw, which moves hubert's smoke logits by up to 0.09.
    The constants are host floats rounded to x's dtype: a product with
    one is exact in f32 and rounded once, as the reference's is, and no
    constant is copied to the card.  Under grad its gradient rounds where
    the reference's does (``_GELU``)."""
    return _GELU.apply(x) if _needs_grad(x) else _gelu_steps(x)[-1]


def _gelu_steps(x):
    """x^2, the tanh, the cdf and gelu(x), each step in x's dtype."""
    c1, c2 = (float(torch.tensor(c, dtype=x.dtype))
              for c in (0.044715, math.sqrt(2.0 / math.pi)))
    x2 = x * x
    t = torch.tanh(c2 * (x + c1 * (x2 * x)))
    cdf = 0.5 * (1 + t)
    return x2, t, cdf, x * cdf


class _GELU(torch.autograd.Function):
    """``gelu``'s steps, with the gradient rounded where the reference's
    autodiff rounds it, each step in x's dtype: the transposes of x^3's
    tangent g (3 x^2), tanh's (g + g t)(1 - t) and the products and sums
    around them, the three terms of x's gradient added in the order the
    reference adds them."""

    @staticmethod
    def forward(ctx, x):
        x2, t, cdf, out = _gelu_steps(x)
        ctx.save_for_backward(x, x2, t, cdf)
        return out

    @staticmethod
    def backward(ctx, g):
        x, x2, t, cdf = ctx.saved_tensors
        c1, c2 = (float(torch.tensor(c, dtype=x.dtype))
                  for c in (0.044715, math.sqrt(2.0 / math.pi)))
        a = (0.5 * (g * x)) * (1 - t)          # through cdf = 0.5 (1 + t)
        v = c2 * (a + a * t)                   # through tanh, then c2 (.)
        return (g * cdf + v) + (c1 * v) * (3 * x2)


def mlp(x, p, act: str = "silu"):
    """Gated MLP over one layer's weights."""
    up = x @ p["w_up"]
    if act == "silu":
        h = silu(x @ p["w_gate"]) * up
    else:
        h = gelu(up)                           # jax.nn.gelu's default
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention, plain PyTorch
# ---------------------------------------------------------------------------

def _mask_block(q_pos, k_pos, causal: bool, window, prefix_len):
    """(Bq, Bk) boolean mask for one block pair."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        c = q_pos[:, None] >= k_pos[None, :]
        if prefix_len is not None:
            # prefix-LM: bidirectional over the first ``prefix_len`` tokens
            c = c | (k_pos[None, :] < prefix_len)
        m &= c
    m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def blockwise_attention(q, k, v, *, causal: bool = True, window=GLOBAL_WINDOW,
                        prefix_len=None, q_offset=0, block_kv: int = 512,
                        softmax_scale: Optional[float] = None):
    """Online-softmax attention.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D) — GQA via head grouping.
    ``q_offset``: absolute position of q[0] (decode / chunked prefill).
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = softmax_scale or (1.0 / math.sqrt(D))
    # the scale is applied in q's dtype, before the cast, as the reference has it
    qf = (q * scale).float().reshape(B, Sq, KV, G, D)
    block_kv = min(block_kv, Skv)
    n_blocks = max(1, (Skv + block_kv - 1) // block_kv)
    pad = n_blocks * block_kv - Skv
    kb = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(
        B, n_blocks, block_kv, KV, D).float()
    vb = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        B, n_blocks, block_kv, KV, D).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m_run = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        k_pos = i * block_kv + torch.arange(block_kv, device=q.device)
        # scores: (B, Sq, KV, G, block)
        s = torch.einsum("bqkgd,bnkd->bqkgn", qf, kb[:, i])
        mask = _mask_block(q_pos, k_pos, causal, window, prefix_len)
        mask &= (k_pos < Skv)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgn,bnkd->bqkgd", p,
                                                   vb[:, i])
        m_run = m_new
    out = acc / torch.clamp_min(l_run[..., None], 1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_block(x, p, cfg, positions, *, causal=True,
                    window=GLOBAL_WINDOW, prefix_len=None,
                    block_kv: int = 512):
    """Full attention sub-block over one layer's weights: projections,
    qk-norm, RoPE, attention, output projection.  ``prefix_len`` (when
    causal): every query also sees the keys before it (paligemma's image
    prefix).

    On a CUDA tensor the attention is the flash-attention kernel (window 0
    for a global layer, prefix 0 for none); on the CPU it is
    ``blockwise_attention``."""
    B, S, d = x.shape
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, D)
    k = (x @ p["wk"]).reshape(B, S, KV, D)
    v = (x @ p["wv"]).reshape(B, S, KV, D)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if x.is_cuda:
        o = flash_attention(q, k, v, causal=causal,
                            window=0 if window >= GLOBAL_WINDOW else window,
                            prefix_len=prefix_len or 0)
    else:
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len, block_kv=block_kv)
    return o.reshape(B, S, H * D) @ p["wo"]


def decode_attention(q, k_cache, v_cache, cache_len, *, window=GLOBAL_WINDOW):
    """Single-token decode over a KV cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); ``cache_len``: current length
    (the new token is already written at cache_len-1).
    """
    B, _, H, D = q.shape
    _, Smax, KV, _ = k_cache.shape
    G = H // KV
    qf = (q.float() / math.sqrt(D)).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())  # (B, KV, G, Smax)
    pos = torch.arange(Smax, device=q.device)[None, :]
    # a Python int stays on the host: copying it to the card each layer
    # would make the host wait for the card
    clen = (cache_len.reshape(-1, 1) if isinstance(cache_len, torch.Tensor)
            else cache_len)                              # (B?, 1) or int
    valid = (pos < clen) & (pos >= clen - window)        # (B? or 1, Smax)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)
