"""Plain PyTorch versions of the mamba2_ssd kernels: the chunked SSD scan
(``ssd_torch``) and its gradient (``ssd_bwd_torch``, the backward kernel's
plain version, written out chunk by chunk as that kernel computes it and
not by autograd, so that autograd of ``ssd_torch`` stays an independent
oracle).

``ssd_torch`` computes what the TPU kernel's wrapper
(``src/repro/kernels/mamba2_ssd/kernel.py::ssd``) computes, and what the
CUDA kernel computes, chunk by chunk in f32 with the same three products::

    la      = -dt * exp(A_log)                                   (<= 0)
    cum     = inclusive cumsum of la over the chunk
    y_state = exp(cum) * (C @ S^T)                               (L,N)(N,P)
    y_intra = (tril(exp(cum_t - cum_i)) * (C B^T) * dt_i) @ x    (L,L)(L,P)
    S'      = exp(cum_L) S + (dt * exp(cum_L - cum) * x)^T B     (P,L)(L,N)
    y       = y_state + y_intra + D * x

The exponent is evaluated only where i <= t (a double ``where``), since an
exp of a positive exponent above the diagonal overflows.  The ragged final
chunk is padded with zeros, which add nothing (dt = 0 there).

Rounding: the ``D * x`` skip is added in f32 and the sum rounded once to
x's dtype, as the model's own path (``models/mamba2.py::ssd_chunked``)
does.  The TPU wrapper rounds twice (``y`` to x's dtype, then the skip in
f32 and again), so in bf16 the two differ by at most one bf16 ulp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_torch(x, dt, A_log, B, C, D, chunk: int = 64):
    """Chunked SSD.  x: (B, S, H, P); dt: (B, S, H); B/C: (B, S, N), one
    group shared by all heads; A_log/D: (H,).  Returns y: (B, S, H, P) in
    x's dtype."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    n = -(-S // chunk)
    pad = n * chunk - S
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, n, chunk, H, P)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, H)
    Bc = F.pad(B.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    Cc = F.pad(C.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    lac = -dtc * torch.exp(A_log.float())                 # (B, n, L, H) <= 0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(n):
        xb, dtb, Bb, Cb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(lac[:, c], dim=1)              # (B, L, H)
        # inter-chunk: y_t += exp(cum_t) * S C_t
        y_state = torch.einsum("bhpn,bln->blhp", state, Cb) \
            * torch.exp(cum)[..., None]
        # intra-chunk: y_t += sum_{i<=t} exp(cum_t - cum_i) dt_i (C_t.B_i) x_i
        expo = cum[:, :, None, :] - cum[:, None, :, :]    # (B, L, L, H)
        g = torch.where(tri, torch.exp(torch.where(tri, expo, 0.0)), 0.0)
        cb = torch.einsum("bln,bin->bli", Cb, Bb)         # (B, L, L)
        w = g * cb[..., None] * dtb[:, None, :, :]        # (B, L, L, H)
        ys.append(y_state + torch.einsum("blih,bihp->blhp", w, xb))
        # state update; every exponent is <= 0
        k_dec = torch.exp(cum[:, -1:, :] - cum) * dtb     # (B, L, H)
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("blhp,bln->bhpn", xb * k_dec[..., None], Bb)
    y = torch.stack(ys, dim=1).reshape(Bsz, n * chunk, H, P)[:, :S]
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd_bwd_torch(x, dt, A_log, B, C, D, dy, chunk: int = 64, *,
                  omit=()):
    """Gradients of ``ssd_torch`` with respect to (x, dt, A_log, B, C, D),
    given dy, written out chunk by chunk as the backward kernel computes
    them, in f32: a forward sweep that recomputes each chunk's entry state
    S_c, then a reverse sweep that carries dS, the gradient of the state
    leaving the chunk.  Per chunk, with W[t, i] = exp(cum_t - cum_i)
    (C_t . B_i) dt_i (i <= t) and kdec_i = dt_i exp(cum_L - cum_i)::

        y_state:  dC_t  += exp(cum_t) dy_t S_c         dcum_t += C_t . that
                  dS_c  += sum_t exp(cum_t) dy_t C_t^T
        y_intra:  dW     = dy x^T (i <= t);  dx += W^T dy
                  dcb    = sum_h dW g dt_i  -> dC += dcb B,  dB += dcb^T C
                  M      = dW g (C_t . B_i): ddt_i += sum_t M,
                           dcum_t += sum_{i<t} M dt_i,
                           dcum_i -= sum_{t>i} M dt_i
        state:    dS_c  += exp(cum_L) dS;  dx_i += kdec_i B_i dS^T
                  dB_i  += kdec_i x_i dS;   dk_i = B_i . (x_i dS)
                  ddt_i += dk_i exp(cum_L - cum_i)
                  dcum_i -= dk_i kdec_i  (i < L)
                  dcum_L += sum_{i<L} dk_i kdec_i + exp(cum_L) sum(dS * S_c)
        dla = reverse cumsum of dcum;  ddt += -exp(A_log) dla
        dA_log += sum dla la;  dD += sum dy x;  dx += D dy

    M's diagonal and the last step's dk kdec would enter dcum twice with
    opposite signs; they are left out of both places, since in f32 the two
    roundings would not cancel and la (up to -50 a step) would amplify the
    rest into dA_log and ddt.  B and C are shared by the heads, so dB and
    dC sum over them.  Returns
    the gradients in the dtypes of their inputs.

    ``omit`` names terms to leave out, so that a check can show that its
    bound catches a backward that loses them: ``"carry"`` drops dS where
    the reverse sweep leaves chunk n // 2 for the chunk before it,
    ``"decay_term"`` the exp(cum_L) sum(dS * S_c) term of dcum_L, and
    ``"head_dcb"`` head 0's dcb from the sum over the heads that dB and dC
    take (the sum the bf16 kernel forms per group of heads)."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    n = -(-S // chunk)
    pad = n * chunk - S
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, n, chunk, H, P)
    dyc = F.pad(dy.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, n, chunk, H,
                                                           P)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, H)
    Bc = F.pad(B.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    Cc = F.pad(C.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    A = torch.exp(A_log.float())
    lac = -dtc * A                                        # (B, n, L, H) <= 0
    cumc = torch.cumsum(lac, dim=2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device), -1)[None, :, :, None]
    # forward sweep: the state entering each chunk
    states = []
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    for c in range(n):
        states.append(state)
        cum = cumc[:, c]
        kdec = torch.exp(cum[:, -1:] - cum) * dtc[:, c]
        state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "blhp,bln->bhpn", xc[:, c] * kdec[..., None], Bc[:, c])
    # reverse sweep, carrying dS
    dS = torch.zeros_like(state)
    dxs, ddts, dBs, dCs = [], [], [], []
    dA_log = torch.zeros((H,), dtype=torch.float32, device=x.device)
    for c in reversed(range(n)):
        xb, dyb, dtb, Bb, Cb = xc[:, c], dyc[:, c], dtc[:, c], Bc[:, c], \
            Cc[:, c]
        cum, s_in = cumc[:, c], states[c]
        ecum = torch.exp(cum)                             # (B, L, H)
        # y_state = exp(cum_t) C_t S_c^T
        dC_state = torch.einsum("blhp,bhpn->blhn", dyb, s_in) \
            * ecum[..., None]
        dcum = (dC_state * Cb[:, :, None, :]).sum(-1)     # (B, L, H)
        dC_c = dC_state.sum(2)
        dS_in = torch.einsum("blhp,bln->bhpn", dyb * ecum[..., None], Cb)
        # y_intra = W x
        expo = cum[:, :, None, :] - cum[:, None, :, :]    # (B, t, i, H)
        g = torch.where(tri, torch.exp(torch.where(tri, expo, 0.0)), 0.0)
        cb = torch.einsum("bln,bin->bli", Cb, Bb)         # (B, t, i)
        dW = torch.where(tri, torch.einsum("blhp,bihp->blih", dyb, xb), 0.0)
        w = g * cb[..., None] * dtb[:, None, :, :]
        dx_c = torch.einsum("blih,blhp->bihp", w, dyb)
        m = dW * g * cb[..., None]
        dcb_h = dW * g * dtb[:, None, :, :]               # (B, t, i, H)
        if "head_dcb" in omit:
            dcb_h = dcb_h[..., 1:]
        dcb = dcb_h.sum(-1)                               # (B, t, i)
        dC_c = dC_c + torch.einsum("bli,bin->bln", dcb, Bb)
        dB_c = torch.einsum("bli,bln->bin", dcb, Cb)
        ddt_c = m.sum(1)                                  # (B, i, H)
        # M's diagonal adds m dt to dcum_t through both sums and cancels:
        # it is left out (in f32 the two roundings would not cancel, and la
        # amplifies what is left into dA_log and ddt)
        q = torch.where(strict, m * dtb[:, None, :, :], 0.0)
        dcum = dcum + q.sum(2) - q.sum(1)
        # S' = exp(cum_L) S_c + sum_i kdec_i x_i^T B_i
        cum_l = cum[:, -1]                                # (B, H)
        dec = torch.exp(cum_l[:, None] - cum)             # (B, L, H)
        kdec = dec * dtb
        xdS = torch.einsum("bihp,bhpn->bihn", xb, dS)     # (B, L, H, N)
        dk = (xdS * Bb[:, :, None, :]).sum(-1)            # (B, L, H)
        dB_c = dB_c + (kdec[..., None] * xdS).sum(2)
        dx_c = dx_c + kdec[..., None] * torch.einsum("bin,bhpn->bihp", Bb,
                                                     dS)
        ddt_c = ddt_c + dk * dec
        # dcum_i -= dk_i kdec_i and dcum_L += sum_i dk_i kdec_i: the last
        # step's own term cancels, and is left out of both
        kk = (dk * kdec)[:, :-1]
        dcum[:, :-1] -= kk
        dcum[:, -1] += kk.sum(1)
        if "decay_term" not in omit:
            dcum[:, -1] += torch.exp(cum_l) * (dS * s_in).sum((-1, -2))
        dS = dS * torch.exp(cum_l)[..., None, None] + dS_in
        if "carry" in omit and c == n // 2:
            dS = torch.zeros_like(dS)
        # cum -> la -> dt, A_log
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt_c = ddt_c - A * dla
        dA_log = dA_log + (dla * lac[:, c]).sum((0, 1))
        dxs.append(dx_c)
        ddts.append(ddt_c)
        dBs.append(dB_c)
        dCs.append(dC_c)

    def unchunk(parts, *tail):
        return torch.stack(parts[::-1], dim=1).reshape(Bsz, n * chunk,
                                                       *tail)[:, :S]
    xf, dyf = x.float(), dy.float()
    dx = unchunk(dxs, H, P) + D.float()[None, None, :, None] * dyf
    dD = (dyf * xf).sum((0, 1, 3))
    return (dx.to(x.dtype), unchunk(ddts, H).to(dt.dtype),
            dA_log.to(A_log.dtype), unchunk(dBs, N).to(B.dtype),
            unchunk(dCs, N).to(C.dtype), dD.to(D.dtype))
