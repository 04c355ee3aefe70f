"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full / sliding
window / prefix-LM), gated MLPs (the JAX package's ``models/layers.py``, in
PyTorch).

``blockwise_attention`` is the plain version: an online softmax over KV
blocks, as in the reference.  ``attention_block`` sends prefill attention on
a CUDA tensor to the hand-written flash-attention kernel
(``kernels/flash_attention``) and on a CPU or ``meta`` tensor to the plain
version; the choice follows the tensor's device type, never a failure.  On
the ``DTensor``s of a sharded step the attention runs per device on its
local heads (``local_map``, placements from the ``q_heads`` / ``kv_heads``
rules), so each device launches the kernel once on its shard; q, k and v
are constrained to whole heads where the config asks for it
(``attn_head_shard="heads"``), at the reference's places.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis.kernel_cost import as_kernel, flash_cost
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.ctx import (constrain, is_dtensor, local_placements,
                                      per_device, shard_offset)

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
    q = split_heads(x @ p["wq"], H, D)
    k = split_heads(x @ p["wk"], KV, D)
    v = split_heads(x @ p["wv"], KV, D)
    if cfg.attn_head_shard == "heads":
        q = constrain(q, "q_heads")
        k = constrain(k, "kv_heads")
        v = constrain(v, "kv_heads")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    mask = dict(causal=causal, window=window, prefix_len=prefix_len,
                block_kv=block_kv)
    if is_dtensor(q):
        o = _sharded_attention(q, k, v, **mask)
    else:
        o = _attention(q, k, v, **mask)
    return o.reshape(B, S, H * D) @ p["wo"]


def whole_over(t, dim: int, n: int):
    """``t``; a ``DTensor`` whose dim ``dim`` is split over more devices
    than divide ``n`` gathered along it first, so that a reshape of that
    dim into ``n`` parts (heads) never cuts a part across devices."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t
    mesh = t.device_mesh
    split = math.prod(mesh.size(m) for m, pl in enumerate(placements)
                      if pl.is_shard(dim))
    if n % split == 0:
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, [Replicate() if pl.is_shard(dim) else pl
                                 for pl in placements])


def split_heads(t, n: int, D: int):
    """(..., n D) -> (..., n, D), whole heads on each device
    (``whole_over``: with a head count the model axis does not divide, the
    reference's kv heads replicate in its whole-head mode too)."""
    t = whole_over(t, t.ndim - 1, n)
    return t.reshape(*t.shape[:-1], n, D)


def _attention(q, k, v, *, causal, window, prefix_len, block_kv):
    """Attention on one device's tensors: the flash kernel on a CUDA
    tensor, ``blockwise_attention`` on a CPU or ``meta`` one (on ``meta``
    costed as the flash kernel's launch, ``kernel_cost.as_kernel``)."""
    kernel_window = 0 if window >= GLOBAL_WINDOW else window
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=kernel_window,
                               prefix_len=prefix_len or 0)

    def plain(q, k, v):
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, block_kv=block_kv)
    if q.device.type == "cpu":
        return plain(q, k, v)
    if q.device.type == "meta":
        return as_kernel("flash_attention", plain, functools.partial(
            flash_cost, causal=causal, window=kernel_window,
            prefix_len=prefix_len or 0), q, k, v)
    raise ValueError(f"attention runs on cuda, cpu or meta, not {q.device}")


def _sharded_attention(q, k, v, **mask):
    """``_attention`` on each device's local heads of DTensors q, k, v:
    batch (when it shards) and q heads as the ``q_heads`` rule lays them
    out (all heads on every device of the model axis when it does not
    divide them, a drop ``local_placements`` says); k and v heads shard
    with them where the model axis divides both head counts, else k and v
    replicate over it and each device picks the kv heads its q heads read
    (GQA's h // G)."""
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qp = list(local_placements("q_heads", q.shape))
    split = math.prod(mesh.size(m) for m, pl in enumerate(qp)
                      if pl.is_shard(2))
    whole = [Replicate() if pl.is_shard(2) else pl for pl in qp]
    even = KV % split == 0
    kvp = qp if even else whole
    h0 = 0 if even else shard_offset(H, mesh, qp, 2)
    G = H // KV

    def local(ql, kl, vl):
        if not even:
            heads = (h0 + torch.arange(ql.shape[2])) // G
            kv_idx = torch.unique_consecutive(heads)
            if heads.numel() % kv_idx.numel() == 0 and torch.equal(
                    heads, kv_idx.repeat_interleave(
                        heads.numel() // kv_idx.numel())):
                heads = kv_idx
            kl = kl[:, :, heads.to(kl.device)].contiguous()
            vl = vl[:, :, heads.to(vl.device)].contiguous()
        return _attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                          **mask)
    return per_device(local, list(qp), (qp, kvp, kvp), mesh)(q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=GLOBAL_WINDOW):
    """Single-token decode over a KV cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); ``cache_len``: current length
    (the new token is already written at cache_len-1).  On DTensors it runs
    per device (``_sharded_decode_attention``).
    """
    if is_dtensor(q):
        return _sharded_decode_attention(q, k_cache, v_cache, cache_len,
                                         window)
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


def _sharded_decode_attention(q, k_cache, v_cache, cache_len: int, window):
    """``decode_attention`` on DTensors, per device: each device attends
    over its own slice of the cache — its batch rows, its kv heads where
    the model axis divides them (with their q heads), its positions where
    the cache's sequence is split (``cache_specs``' sequence-parallel
    layout) — and returns its row maxima, sums and unnormalised outputs,
    which are combined across the sequence's slices as flash-decoding
    does (rescaled to the global maximum, summed, divided).  With the
    sequence whole on every device, each runs ``decode_attention``'s own
    arithmetic on its rows and heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    B, _, H, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    cache_pl = [pl if pl.is_shard() and pl.dim in (0, 1, 2) else Replicate()
                for pl in k_cache.placements]
    cache_pl = [Replicate() if pl.is_shard(2) and KV % mesh.size(m)
                else pl for m, pl in enumerate(cache_pl)]
    q_pl = [pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
            for pl in cache_pl]
    # the outputs are (split, B, KV, G[, D]): the cache's positions (its
    # dim 1) become the split axis, its batch (0) dim 1, its kv heads (2)
    # dim 2
    at = {0: 1, 1: 0, 2: 2}
    out_pl = [Shard(at[pl.dim]) if pl.is_shard() else Replicate()
              for pl in cache_pl]
    clen = int(cache_len)
    if not any(pl.is_shard(1) for pl in cache_pl):
        # every device holds whole rows: the unsharded arithmetic, as it is
        return per_device(
            lambda ql, kl, vl: decode_attention(ql, kl, vl, clen,
                                                window=window),
            q_pl, (q_pl, cache_pl, cache_pl), mesh)(q, k_cache, v_cache)
    s0 = shard_offset(Smax, mesh, cache_pl, 1)

    def local(ql, kl, vl):
        b, kv = ql.shape[0], kl.shape[2]
        qf = (ql.float() / math.sqrt(D)).reshape(b, kv, -1, D)
        s = torch.einsum("bkgd,bskd->bkgs", qf, kl.float())
        pos = s0 + torch.arange(kl.shape[1], device=ql.device)
        valid = (pos < clen) & (pos >= clen - window)
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bkgs,bskd->bkgd", p, vl.float())
        return m[None], p.sum(dim=-1)[None], o[None]
    m, l, o = per_device(local, (out_pl, out_pl, out_pl),
                         (q_pl, cache_pl, cache_pl), mesh)(
                             q, k_cache, v_cache)
    top = m.amax(dim=0)
    w = torch.exp(m - top[None])
    o = (o * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]
    return o.reshape(B, 1, H, D).to(q.dtype)
