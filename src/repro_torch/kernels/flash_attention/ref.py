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

``flash_attention_bwd_torch`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``), computed the kernel's way: P recomputed
from the forward's log-sum-exp (``flash_attention_torch(...,
return_lse=True)``), then D = rowsum(dO o O) and dS = P o (dP - D).  The
plain versions compute in f32, or in f64 for f64 inputs (so that the
autograd Function's CPU route can be checked by ``gradcheck``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions compute in: f64 for f64, else f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _keep(q_pos, k_pos, Skv: int, causal: bool, window: int,
          prefix_len: int):
    """The kernel's mask of (query, key) positions: kp < Skv, and (causal)
    qp >= kp or kp < prefix_len, and (window > 0) qp - kp < window."""
    mask = k_pos < Skv
    if causal:
        mask = mask & ((q_pos >= k_pos) | (k_pos < prefix_len))
    if window > 0:
        mask = mask & ((q_pos - k_pos) < window)
    return mask


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
                          prefix_len: int = 0, bk: int = 128,
                          return_lse: bool = False):
    """Blocked online-softmax attention, the TPU kernel's arithmetic.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D), H a multiple of KV.  Query and
    key positions are absolute, 0-based, with no ``Skv - Sq`` offset.
    Returns (B, Sq, H, D) in q's dtype; with ``return_lse`` also each
    row's log-sum-exp of its scaled scores, m + log(max(l, 1e-30)), as
    (B, H, Sq) in f32 (f64 for f64 inputs), what the kernel writes for the
    backward."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    bk = min(bk, Skv)
    n_kv = -(-Skv // bk)
    pad = n_kv * bk - Skv
    # (B, KV, G, Sq, D) and (B, KV, Skv + pad, D); the cast comes before the
    # scale, as in the kernel
    acc_t = _acc(q)
    qf = (q.to(acc_t) * scale).reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kf = F.pad(k.to(acc_t), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    vf = F.pad(v.to(acc_t), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq, 1), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=acc_t, device=q.device)
    for j in range(n_kv):
        kb = kf[:, :, j * bk:(j + 1) * bk]
        vb = vf[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bkgqd,bknd->bkgqn", qf, kb)
        k_pos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = _keep(q_pos, k_pos, Skv, causal, window, prefix_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgqn,bknd->bkgqd", p, vb)
        m = m_new
    den = torch.clamp_min(l, 1e-30)
    out = (acc / den).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(den)).reshape(B, H, Sq)


def flash_attention_bwd_torch(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, prefix_len: int = 0,
                              bk: int = 128):
    """The gradient of ``flash_attention_torch`` from its output ``o``, the
    output's gradient ``do`` and its log-sum-exp ``lse`` (B, H, Sq), block
    by block over ``bk`` keys as the backward kernel computes it: P =
    exp(s - lse) under the mask, D = rowsum(do o o), dP = do V^T, dS = P o
    (dP - D), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T do.
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    acc_t = _acc(q)

    def heads(t):                        # (B, S, H, D) -> (B, KV, G, S, D)
        return t.to(acc_t).reshape(B, t.shape[1], KV, G, D) \
            .permute(0, 2, 3, 1, 4)

    qf, dof = heads(q) * scale, heads(do)
    kf = k.to(acc_t).permute(0, 2, 1, 3)              # (B, KV, Skv, D)
    vf = v.to(acc_t).permute(0, 2, 1, 3)
    delta = (dof * heads(o)).sum(-1, keepdim=True)    # (B, KV, G, Sq, 1)
    lse = lse.to(acc_t).reshape(B, KV, G, Sq, 1)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j0 in range(0, Skv, bk):
        kb, vb = kf[:, :, j0:j0 + bk], vf[:, :, j0:j0 + bk]
        k_pos = j0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = _keep(q_pos, k_pos, Skv, causal, window, prefix_len)
        s = torch.einsum("bkgqd,bknd->bkgqn", qf, kb)
        p = torch.exp((s - lse).masked_fill(~mask, float("-inf")))
        dp = torch.einsum("bkgqd,bknd->bkgqn", dof, vb)
        ds = p * (dp - delta)
        dv[:, :, j0:j0 + bk] = torch.einsum("bkgqn,bkgqd->bknd", p, dof)
        dk[:, :, j0:j0 + bk] = torch.einsum("bkgqn,bkgqd->bknd", ds, qf)
        dq += torch.einsum("bkgqn,bknd->bkgqd", ds, kb)
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
