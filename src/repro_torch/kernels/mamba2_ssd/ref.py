"""Plain PyTorch version of the mamba2_ssd kernel: the chunked SSD scan.

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
