"""RWKV-6 "Finch": linear attention with a data-dependent per-channel decay
(the JAX package's ``models/rwkv6.py``, in PyTorch).

Prefill uses the chunked form: within a chunk every per-channel decay
exponent is non-positive, so every exp() is safe, and the (K, K) state is
carried from chunk to chunk.  Decode is the O(1) sequential recurrence.

Recurrence (per head, state S in R^{K x V}):
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(ww x_t + b)) in (0, 1) data-dependent.

``rwkv6_layer``'s prefill WKV goes through ``kernels/rwkv6.ops.wkv6``,
which launches the hand-written WKV kernel on a CUDA tensor and runs
``wkv6_chunked`` on a CPU tensor; a ``meta`` tensor (the dry-run's trace)
runs ``wkv6_chunked`` directly, costed as one launch of the kernel each way
(``analysis.kernel_cost.as_kernel``).  The choice follows the tensor's
device type, never a failure.  On the ``DTensor``s of a sharded step the
WKV runs per device on its heads (``local_map``; heads over the model axis,
batch over DP when it shards, as ``cache_specs``' ``wkv`` entry lays out
the state), one kernel launch a device.  In training (an input requires
grad) the WKV goes through ``ops.WKV6Fn``, whose backward launches the
hand-written backward kernel on the card and runs ``ref.wkv6_bwd_torch`` on
the CPU: rwkv6 trains on both.  The clamp of log_w at ``LOG_W_MIN`` stays
outside the kernels, in autograd.  Decode's one-step update is plain
PyTorch, as it is plain jnp in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.kernel_cost import as_kernel, wkv_cost
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref, wkv6_torch
from repro_torch.models.layers import rms_norm, sigmoid, silu
from repro_torch.sharding.ctx import (is_dtensor, local_placements,
                                      per_device)

LOG_W_MIN = -8.0     # clamp per-token log-decay for numerical safety

#: the chunked WKV that ``wkv6`` runs on the CPU: the kernel's plain version
wkv6_chunked = wkv6_torch


def _proj_rkvwg(x, x_prev, p):
    """Token-shift mixes + five projections.  x: (B, S, d), x_prev: (B, d).
    Returns r, k, v, g in x's dtype and the f32 log decay, clamped at
    ``LOG_W_MIN``."""
    mix = sigmoid(p["mix"])                                # (5, d)
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)

    def mixed(i):
        return x * mix[i] + xs * (1.0 - mix[i])
    r = mixed(0) @ p["wr"]
    k = mixed(1) @ p["wk"]
    v = mixed(2) @ p["wv"]
    lw = mixed(3) @ p["ww"] + p["w_bias"]
    g = silu(mixed(4) @ p["wg"])
    log_w = -torch.exp(lw.float())                         # <= 0
    return r, k, v, log_w.clamp_min(LOG_W_MIN), g


def _wkv(r, k, v, log_w, u):
    """The WKV on one device's tensors, or per device on DTensors."""
    if is_dtensor(r):
        h4, heads = (local_placements("q_heads", r.shape),
                     local_placements("heads", u.shape))
        return per_device(_wkv, list(h4), (h4, h4, h4, h4, heads),
                          r.device_mesh)(r, k, v, log_w, u)
    if r.device.type == "meta":
        return as_kernel("rwkv6", wkv6_chunked, wkv_cost, r, k, v, log_w, u)
    return wkv6(r, k, v, log_w, u)


def rwkv6_layer(x, x_prev_tmix, x_prev_cmix, p, cfg):
    """One RWKV6 block over one layer's weights: time mix + channel mix.
    x: (B, S, d); the previous token's normed inputs of the time and
    channel mixes: (B, d).  Returns (out, the last token's time-mix input,
    its channel-mix input)."""
    B, S, d = x.shape
    H = cfg.n_heads
    K = d // H
    h = rms_norm(x, p["norm1"])
    r, k, v, log_w, g = _proj_rkvwg(h, x_prev_tmix, p)
    o = _wkv(r.reshape(B, S, H, K), k.reshape(B, S, H, K),
             v.reshape(B, S, H, K), log_w.reshape(B, S, H, K),
             p["u"].reshape(H, K)).reshape(B, S, d)
    o = rms_norm(o, p["ln_x"]) * g
    x = x + o @ p["wo"]
    # channel mix (rwkv ffn): square-relu with receptance gate
    h2 = rms_norm(x, p["norm2"])
    h2s = torch.cat([x_prev_cmix[:, None, :], h2[:, :-1, :]], dim=1)
    kk2 = torch.square(torch.relu(h2 @ p["ffn_k"]))
    rr2 = sigmoid(h2s @ p["ffn_r"])
    x = x + rr2 * (kk2 @ p["ffn_v"])
    return x, h[:, -1, :], h2[:, -1, :]


def rwkv6_decode_step(x, tmix_state, cmix_state, wkv_state, p, cfg):
    """One-token decode.  x: (B, d); wkv_state: (B, H, K, K) f32.  Returns
    (out, the new time-mix and channel-mix states, the new WKV state)."""
    B, d = x.shape
    H = cfg.n_heads
    K = d // H
    h = rms_norm(x, p["norm1"])
    r, k, v, log_w, g = _proj_rkvwg(h[:, None, :], tmix_state, p)
    rr = r.reshape(B, H, K).float()
    kk = k.reshape(B, H, K).float()
    vv = v.reshape(B, H, K).float()
    w = torch.exp(log_w.reshape(B, H, K))
    u = p["u"].reshape(H, K).float()
    kv = torch.einsum("bhk,bhv->bhkv", kk, vv)
    o = torch.einsum("bhk,bhkv->bhv", rr,
                     wkv_state + u[None, :, :, None] * kv)
    wkv_state = wkv_state * w[..., None] + kv
    o = o.reshape(B, 1, d).to(x.dtype)
    o = rms_norm(o, p["ln_x"]) * g
    x = x + (o @ p["wo"])[:, 0]
    h2 = rms_norm(x, p["norm2"])
    kk2 = torch.square(torch.relu(h2 @ p["ffn_k"]))
    rr2 = sigmoid(cmix_state @ p["ffn_r"])
    x = x + rr2 * (kk2 @ p["ffn_v"])
    return x, h, h2, wkv_state


def wkv6_sequential(r, k, v, log_w, u):
    """Sequential oracle for tests (token-by-token recurrence), in f32."""
    return wkv6_ref(r.float(), k, v, log_w, u)
