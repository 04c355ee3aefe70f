"""Plain PyTorch versions of the rwkv6 kernels: the chunked WKV, its
token-by-token oracle, and the WKV's gradient (``wkv6_bwd_torch``, the
backward kernel's plain version, written out chunk by chunk as that kernel
computes it and not by autograd, so that autograd of ``wkv6_torch`` stays
an independent oracle).

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


def wkv6_bwd_torch(r, k, v, log_w, u, do, chunk: int = 32, *, omit=()):
    """Gradients of ``wkv6_torch`` with respect to (r, k, v, log_w, u),
    given do, written out chunk by chunk as the backward kernel computes
    them, in f32: a forward sweep that recomputes each chunk's entry state
    S_c, then a reverse sweep that carries dS, the gradient of the state
    leaving the chunk.  Per chunk, with E[t, i, d] = exp(cum_ex_t[d] -
    cum_i[d]) for i < t (masked before the exp, as in the forward),
    kdec_i = k_i exp(cum_L - cum_i) and beta_t = sum_d r_t u k_t::

        o_state:  dr_t  += exp(cum_ex_t) (do_t S_c^T)
                  dS_c  += sum_t (r_t exp(cum_ex_t)) do_t^T
        a v:      dA     = do v^T (i < t);  dv += A^T do
                  dr_t  += sum_i dA[t, i] k_i E[t, i]
                  dk_i  += sum_t dA[t, i] r_t E[t, i]
        bonus:    dbeta_t = do_t . v_t;  dv_t += beta_t do_t
                  dr_t += dbeta_t u k_t;  dk_t += dbeta_t u r_t
                  du   += sum dbeta_t r_t k_t
        state:    dS_c  += diag(exp(cum_L)) dS;  dv_i += kdec_i dS
                  dkdec_i = v_i dS^T;  dk_i += exp(cum_L - cum_i) dkdec_i
        dcum_ex_t = r_t * (the o_state and a v terms of dr_t)
        dcum_i    = -k_i * (the a v term of dk_i) - kdec_i dkdec_i  (i < L)
        dcum_L   += sum_{i<L} kdec_i dkdec_i + exp(cum_L) sum_c S_c dS
        dlog_w_s  = sum_{t >= s} dcum_t + sum_{t > s} dcum_ex_t

    The last step's kdec dkdec would enter dcum_L twice with opposite
    signs; it is left out of both, since in f32 the two roundings would not
    cancel.  Returns the gradients in the dtypes of their inputs.

    ``omit`` names terms to leave out, so that a check can show that its
    bound catches a backward that loses them: ``"carry"`` drops dS where
    the reverse sweep leaves chunk n // 2 for the chunk before it,
    ``"decay_term"`` the exp(cum_L) sum_c S_c dS term of dcum_L, and
    ``"subblock"`` one off-diagonal sub-block's pairs (t in steps 16-31, i
    in steps 0-15 of every chunk: a sub-block the bf16 kernel forms as a
    product of its own) from the sums over E of dr and dk."""
    B, S, H, K = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def padc(x):
        return F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(
            B, n, chunk, H, K)
    rc, kc, vc, lwc, doc = map(padc, (r, k, v, log_w, do))
    uf = u.float()
    cumc = torch.cumsum(lwc, dim=2)
    cxc = cumc - lwc
    # strictly causal: tri[t, i] = i < t
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[None, :, :, None]
    # forward sweep: the state entering each chunk
    states = []
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    for c in range(n):
        states.append(state)
        cum = cumc[:, c]
        k_dec = kc[:, c] * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bihk,bihv->bhkv", k_dec, vc[:, c])
    # reverse sweep, carrying dS
    dS = torch.zeros_like(state)
    drs, dks, dvs, dlws = [], [], [], []
    du = torch.zeros((H, K), dtype=torch.float32, device=r.device)
    for c in reversed(range(n)):
        rb, kb, vb, dob = rc[:, c], kc[:, c], vc[:, c], doc[:, c]
        cum, cx, s_in = cumc[:, c], cxc[:, c], states[c]
        ecx = torch.exp(cx)
        # o_state = (r exp(cum_ex)) S_c
        dr = torch.einsum("bthv,bhkv->bthk", dob, s_in) * ecx
        dcx = rb * dr
        dS_in = torch.einsum("bthk,bthv->bhkv", rb * ecx, dob)
        # a v, a[t, i] = sum_d r_t k_i E[t, i]
        expo = torch.where(tri[..., None], cx[:, :, None] - cum[:, None],
                           float("-inf"))                 # (B, t, i, H, K)
        e = torch.exp(expo)
        a = torch.einsum("bthk,bihk,btihk->btih", rb, kb, e)
        da = torch.where(tri, torch.einsum("bthv,bihv->btih", dob, vb), 0.0)
        dv = torch.einsum("btih,bthv->bihv", a, dob)
        if "subblock" in omit:
            da = da.clone()
            da[:, 16:32, :16] = 0.0
        dr_a = torch.einsum("btih,bihk,btihk->bthk", da, kb, e)
        dk_a = torch.einsum("btih,bthk,btihk->bihk", da, rb, e)
        dr = dr + dr_a
        dcx = dcx + rb * dr_a
        dcum = -kb * dk_a
        dk = dk_a
        # the bonus beta_t v_t
        beta = (rb * uf * kb).sum(-1)                     # (B, L, H)
        dbeta = (dob * vb).sum(-1)
        dv = dv + beta[..., None] * dob
        dr = dr + dbeta[..., None] * uf * kb
        dk = dk + dbeta[..., None] * uf * rb
        du = du + (dbeta[..., None] * rb * kb).sum((0, 1))
        # S' = diag(exp(cum_L)) S_c + sum_i kdec_i v_i^T
        cum_l = cum[:, -1]                                # (B, H, K)
        dec = torch.exp(cum_l[:, None] - cum)             # (B, L, H, K)
        kdec = kb * dec
        dkdec = torch.einsum("bihv,bhkv->bihk", vb, dS)
        dk = dk + dec * dkdec
        # dcum_i -= kdec_i dkdec_i and dcum_L += sum_i kdec_i dkdec_i: the
        # last step's own term cancels, and is left out of both
        kk = (dkdec * kdec)[:, :-1]
        dcum[:, :-1] -= kk
        dcum[:, -1] += kk.sum(1)
        if "decay_term" not in omit:
            dcum[:, -1] += torch.exp(cum_l) * (s_in * dS).sum(-1)
        dv = dv + torch.einsum("bihk,bhkv->bihv", kdec, dS)
        dS = dS * torch.exp(cum_l)[..., None] + dS_in
        if "carry" in omit and c == n // 2:
            dS = torch.zeros_like(dS)
        # cum and cum_ex -> log_w
        rev_cum = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        rev_cx = torch.flip(torch.cumsum(torch.flip(dcx, [1]), 1), [1]) - dcx
        drs.append(dr)
        dks.append(dk)
        dvs.append(dv)
        dlws.append(rev_cum + rev_cx)

    def unchunk(parts):
        return torch.stack(parts[::-1], dim=1).reshape(B, n * chunk, H,
                                                       K)[:, :S]
    return (unchunk(drs).to(r.dtype), unchunk(dks).to(k.dtype),
            unchunk(dvs).to(v.dtype), unchunk(dlws).to(log_w.dtype),
            du.to(u.dtype))
