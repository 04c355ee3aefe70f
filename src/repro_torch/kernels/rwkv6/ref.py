"""Plain PyTorch versions of the rwkv6 kernel: the chunked WKV and its
token-by-token oracle.

``wkv6_torch`` computes what the TPU kernel and its wrapper
(``src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel``, ``wkv6``) compute,
and what the CUDA kernel computes, chunk by chunk in f32.  Per (batch,
head), over chunks of L steps with a (K, K) state S carried from chunk to
chunk (zero at the start), ``cum`` the inclusive cumsum of log_w over the
chunk and ``cum_ex = cum - log_w``::

    o_state[t] = (r_t * exp(cum_ex_t)) @ S
    a[t, i]    = sum_d r_t[d] k_i[d] exp(cum_ex_t[d] - cum_i[d])    i < t
    o          = o_state + a @ v + (sum_d r_t[d] u[d] k_t[d]) v_t
    S'         = diag(exp(cum_L)) S + sum_i (k_i * exp(cum_L - cum_i)) v_i^T

Every exponent is <= 0 where it is used.  The intra-chunk exponent is
masked to -inf above the diagonal before the exp, where it would be
positive and overflow (up to 8 * L with log_w >= -8), and it is evaluated
per (t, i, d): factored as exp(cum_ex_t) * exp(-cum_i) it overflows f32.
The ragged final chunk is padded with zeros, which add nothing.  The output
is rounded once to r's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wkv6_torch(r, k, v, log_w, u, chunk: int = 32):
    """Chunked WKV6.  r, k, v, log_w: (B, S, H, K); u: (H, K).  Returns
    (B, S, H, K) in r's dtype (the value width equals K)."""
    B, S, H, K = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def padc(x):
        return F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(
            B, n, chunk, H, K)
    rc, kc, vc, lwc = map(padc, (r, k, v, log_w))
    uf = u.float()
    # strictly causal: tri[t, i] = i < t
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[None, :, :, None, None]
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(n):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]
        cum = torch.cumsum(lwb, dim=1)                    # (B, L, H, K)
        cum_ex = cum - lwb
        o_state = torch.einsum("blhk,bhkv->blhv", rb * torch.exp(cum_ex),
                               state)
        expo = cum_ex[:, :, None] - cum[:, None]          # (B, L, L, H, K)
        expo = torch.where(tri, expo, float("-inf"))
        a = (rb[:, :, None] * kb[:, None] * torch.exp(expo)).sum(-1)
        diag = (rb * uf * kb).sum(-1)                     # (B, L, H)
        outs.append(o_state + torch.einsum("btih,bihv->bthv", a, vb)
                    + diag[..., None] * vb)
        k_dec = kb * torch.exp(cum[:, -1:] - cum)         # exponent <= 0
        state = state * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bihk,bihv->bhkv", k_dec, vb)
    out = torch.stack(outs, dim=1).reshape(B, n * chunk, H, K)[:, :S]
    return out.to(r.dtype)


def wkv6_ref(r, k, v, log_w, u):
    """Sequential WKV6, one step of the recurrence at a time::

        o_t = r_t^T (S + diag(u) k_t v_t^T)
        S  <- diag(exp(log_w_t)) S + k_t v_t^T

    r, k, v, log_w: (B, S, H, K); u: (H, K).  Returns r's dtype."""
    B, S, H, K = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = state * w[:, t][..., None] + kv
    return torch.stack(outs, dim=1).to(r.dtype)
