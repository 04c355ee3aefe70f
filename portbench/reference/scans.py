"""The chunked scans in float32: frozen copies of the port's plain versions
(``kernels/mamba2_ssd/ref.py::ssd_torch``, ``kernels/rwkv6/ref.py::
wkv6_torch``), so that a change to the program cannot move them.  Autograd
of these forwards is the reference's gradient."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd(x, dt, A_log, B, C, D, chunk: int = 64):
    """Mamba-2's SSD, chunked.  x: (B, S, H, P); dt: (B, S, H); B, C:
    (B, S, N), one group shared by the heads; A_log, D: (H,).  Per head,
    S_t = exp(-dt_t exp(A_log)) S_{t-1} + dt_t x_t B_t^T and
    y_t = S_t C_t + D x_t."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    n = -(-S // chunk)
    pad = n * chunk - S
    xc = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, n, chunk, H, P)
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, n, chunk, H)
    Bc = F.pad(B, (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    Cc = F.pad(C, (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    lac = -dtc * torch.exp(A_log)                          # <= 0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    state = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(n):
        xb, dtb, Bb, Cb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(lac[:, c], dim=1)               # (B, L, H)
        y_state = torch.einsum("bhpn,bln->blhp", state, Cb) \
            * torch.exp(cum)[..., None]
        expo = cum[:, :, None, :] - cum[:, None, :, :]     # (B, L, L, H)
        g = torch.where(tri, torch.exp(torch.where(tri, expo, 0.0)), 0.0)
        cb = torch.einsum("bln,bin->bli", Cb, Bb)
        w = g * cb[..., None] * dtb[:, None, :, :]
        ys.append(y_state + torch.einsum("blih,bihp->blhp", w, xb))
        k_dec = torch.exp(cum[:, -1:, :] - cum) * dtb
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("blhp,bln->bhpn", xb * k_dec[..., None], Bb)
    y = torch.stack(ys, dim=1).reshape(Bsz, n * chunk, H, P)[:, :S]
    return y + D[None, None, :, None] * x


def wkv(r, k, v, log_w, u, chunk: int = 32):
    """RWKV-6's WKV, chunked.  r, k, v, log_w: (B, S, H, K); u: (H, K).
    Per head, o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T) and
    S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T."""
    B, S, H, K = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def padc(x):
        return F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(B, n, chunk, H, K)
    rc, kc, vc, lwc = map(padc, (r, k, v, log_w))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[None, :, :, None, None]
    state = torch.zeros((B, H, K, K), dtype=r.dtype, device=r.device)
    outs = []
    for c in range(n):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]
        cum = torch.cumsum(lwb, dim=1)                     # (B, L, H, K)
        cum_ex = cum - lwb
        o_state = torch.einsum("blhk,bhkv->blhv", rb * torch.exp(cum_ex),
                               state)
        expo = cum_ex[:, :, None] - cum[:, None]           # (B, L, L, H, K)
        expo = torch.where(tri, expo, float("-inf"))
        a = (rb[:, :, None] * kb[:, None] * torch.exp(expo)).sum(-1)
        diag = (rb * u * kb).sum(-1)                       # (B, L, H)
        outs.append(o_state + torch.einsum("btih,bihv->bthv", a, vb)
                    + diag[..., None] * vb)
        k_dec = kb * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bihk,bihv->bhkv", k_dec, vb)
    return torch.stack(outs, dim=1).reshape(B, n * chunk, H, K)[:, :S]
