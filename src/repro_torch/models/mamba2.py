"""Mamba-2 (SSD) mixer for the Zamba2 hybrid (the JAX package's
``models/mamba2.py``, in PyTorch).

State-space dual form: scalar decay per head per token, chunked (intra-chunk
quadratic with non-positive exponents, inter-chunk state scan).  Decode keeps
an O(1) (conv, state) cache.

Recurrence (per head h, state S in R^{P x N}):
    S_t = a_t S_{t-1} + dt_t (x_t B_t^T)
    y_t = S_t C_t + D x_t
with a_t = exp(-dt_t * exp(A_log_h)).

``mamba2_layer``'s prefill scan goes through
``kernels/mamba2_ssd.ops.ssd``, which launches the hand-written SSD kernel
on a CUDA tensor and runs ``ssd_chunked`` on a CPU tensor; a ``meta``
tensor (the dry-run's trace) runs ``ssd_chunked`` directly, costed as one
launch of the kernel each way (``analysis.kernel_cost.as_kernel``).  The
choice follows the tensor's device type, never a failure.  On the
``DTensor``s of a sharded step the scan runs per device on its heads
(``local_map``; heads over the model axis, batch over DP when it shards, as
``cache_specs``' ``ssm`` entry lays out the state), one kernel launch a
device.  In training (an input requires grad) the scan goes through
``ops.SSDFn``, whose backward launches the hand-written backward kernel on
the card and runs ``ref.ssd_bwd_torch`` on the CPU: zamba2 trains on both.
The ``softplus`` of dt stays outside the kernels, in autograd.  Decode's
one-step update is plain PyTorch, as it is plain jnp in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis.kernel_cost import as_kernel, ssd_cost
from repro_torch.kernels.mamba2_ssd.ops import ssd
from repro_torch.kernels.mamba2_ssd.ref import ssd_torch
from repro_torch.models.layers import rms_norm, silu
from repro_torch.sharding.ctx import (is_dtensor, local_placements,
                                      per_device)

#: the chunked SSD that ``ssd`` runs on the CPU: the kernel's plain
#: version, which adds the D * x skip in f32 and rounds once, as the
#: reference's ``ssd_chunked`` does
ssd_chunked = ssd_torch


def _split_proj(z, cfg):
    """Split the fused input projection into (x, gate, B, C, dt)."""
    H, P, N, d_in = cfg.ssm_dims()
    x, gate, B, C, dt = _split(z, [d_in, d_in, N, N, H])
    return x, gate, B, C, dt, H, P, N, d_in


def _split(t, sizes):
    """``torch.split`` along the last dim, as slices (views, as split's
    are); a ``DTensor`` of this torch slices cleanly where its split
    does not."""
    out, start = [], 0
    for n in sizes:
        out.append(t[..., start:start + n])
        start += n
    return out


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv1d.  x: (B, S, C), w: (K, C).  The K shifted
    products are summed in x's dtype in the reference's order.  On
    DTensors each device convolves its own rows and channels, the whole
    sequence (``_sharded_conv``)."""
    if is_dtensor(x):
        return _sharded_conv(x, w, conv_state)
    K = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return silu(out), xp[:, -(K - 1):, :]


def _sharded_conv(x, w, conv_state):
    """``_causal_conv`` per device (``local_map``): x keeps its batch and
    channel shards and gathers its sequence; the weight and the conv state
    take x's channel shards."""
    from torch.distributed.tensor import Replicate, Shard

    rows = [pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
            for pl in x.placements]
    chans = [Shard(1) if pl.is_shard(2) else Replicate() for pl in rows]
    args = (x, w) if conv_state is None else (x, w, conv_state)
    return per_device(lambda *a: _causal_conv(*a), (rows, rows),
                      (rows, chans, rows)[:len(args)], x.device_mesh)(*args)


def ssd_sequential(x, dt, A_log, B, C, D):
    """Sequential oracle for tests: one step of the recurrence at a time."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    a = torch.exp(-dt.float() * torch.exp(A_log.float()))
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = state * a[:, t][..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t].float(), x[:, t].float(),
            B[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t].float()))
    y = torch.stack(ys, dim=1)
    return (y + D.float()[None, None, :, None] * x.float()).to(x.dtype)


def _scan(x, dt, A_log, B, C, D):
    """The SSD on one device's tensors, or per device on DTensors."""
    if is_dtensor(x):
        h4, h3 = (local_placements("q_heads", x.shape),
                  local_placements("q_heads", dt.shape))
        heads, rows = (local_placements("heads", A_log.shape),
                       local_placements("batch", B.shape))
        return per_device(_scan, list(h4),
                          (h4, h3, heads, rows, rows, heads),
                          x.device_mesh)(x, dt, A_log, B, C, D)
    if x.device.type == "meta":
        return as_kernel("mamba2_ssd", ssd_chunked, ssd_cost,
                         x, dt, A_log, B, C, D)
    return ssd(x, dt, A_log, B, C, D)


def mamba2_layer(x, p, cfg, conv_state=None, ssm_state=None,
                 decode: bool = False):
    """Full Mamba2 block over one layer's weights.  x: (B, S, d).  Returns
    (out, conv_state, ssm_state); in prefill the incoming ``ssm_state`` is
    returned unchanged, as in the reference."""
    B_, S, d = x.shape
    h = rms_norm(x, p["norm"])
    z = h @ p["w_in"]
    xin, gate, Bv, Cv, dt, H, P, N, d_in = _split_proj(z, cfg)
    conv_in = torch.cat([xin, Bv, Cv], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], conv_state)
    xin, Bv, Cv = _split(conv_out, [d_in, N, N])
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    xh = xin.reshape(B_, S, H, P)
    if decode:
        a = torch.exp(-dt[:, 0] * torch.exp(p["A_log"])[None, :])
        x0 = xh[:, 0].float()
        new_state = ssm_state * a[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], x0, Bv[:, 0].float())
        y = torch.einsum("bhpn,bn->bhp", new_state, Cv[:, 0].float())
        y = y + p["D"].float()[None, :, None] * x0
        y = y[:, None].to(x.dtype)
    else:
        y = _scan(xh, dt, p["A_log"], Bv, Cv, p["D"])
        new_state = ssm_state
    y = y.reshape(B_, S, d_in)
    y = rms_norm(y, p["gate_norm"]) * silu(gate)
    return x + y @ p["w_out"], new_conv, new_state
