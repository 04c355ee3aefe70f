"""Plain PyTorch versions of the flash-attention kernel.

``attention_ref`` is plain softmax attention (the oracle, a copy of the JAX
package's ``kernels/flash_attention/ref.py``).  ``flash_attention_torch``
computes what the TPU kernel ``_attn_kernel`` computes, the same way: an
online softmax over KV blocks of ``bk`` keys with f32 statistics and
accumulator, masked scores set to the finite ``NEG_INF``, padded keys masked
by the sequence length, and the output divided by ``max(l, 1e-30)``.  The
tests and the CPU path use it; on the card ``chip_smoke.py`` holds the
hand-written kernel against it.  Both take ``prefix_len``, the reference's
prefix-LM mask (``models/layers.py``'s ``_mask_block``): when causal, a key
before ``prefix_len`` is seen by every query; it is ignored when not causal.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, prefix_len=0):
    """Plain softmax attention.  q: (B,Sq,H,D); k/v: (B,Skv,KV,D)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D) / math.sqrt(D)
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, k.float())
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= (qp >= kp) | (kp < prefix_len)
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          prefix_len: int = 0, bk: int = 128):
    """Blocked online-softmax attention, the TPU kernel's arithmetic.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D), H a multiple of KV.  Query and
    key positions are absolute, 0-based, with no ``Skv - Sq`` offset.
    Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    bk = min(bk, Skv)
    n_kv = -(-Skv // bk)
    pad = n_kv * bk - Skv
    # (B, KV, G, Sq, D) and (B, KV, Skv + pad, D); the cast comes before the
    # scale, as in the kernel
    qf = (q.float() * scale).reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(n_kv):
        kb = kf[:, :, j * bk:(j + 1) * bk]
        vb = vf[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bkgqd,bknd->bkgqn", qf, kb)
        k_pos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = k_pos < Skv
        if causal:
            mask = mask & ((q_pos >= k_pos) | (k_pos < prefix_len))
        if window > 0:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgqn,bknd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
