"""The zamba2 family in plain PyTorch, float32: the layout and initial
values of its weights (the port's parameter layout), its forward pass and
the names of its optimizer leaves.

    embed -> groups of ``shared_attn_every`` Mamba-2 layers, each group
    followed by the one shared attention + MLP block -> final RMSNorm ->
    tied logits

Mamba-2 layer: RMSNorm, the fused input projection to (x, gate, B, C, dt),
a depthwise causal conv (width ``ssm_conv``) and SiLU over (x, B, C),
dt = softplus(dt + dt_bias), the SSD (``scans.ssd``), an RMSNorm of y
gated by SiLU(gate), the output projection, the residual.  The shared
block: RMSNorm, causal multi-head attention with RoPE, the residual,
RMSNorm, a SiLU-gated MLP, the residual.  Its departures from the
published Zamba2 are listed in ``configs/zamba2-2.7b.json``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.reference.common import GAIN
from portbench.reference.scans import ssd

#: the reference's SSD chunk: any length gives the same sums; 128 halves
#: the loop of the port's 64
SSD_CHUNK = 128


def ssm_dims(m):
    P = m["ssm_head_dim"]
    H = max(1, 2 * m["d_model"] // P)
    return H, P, m["ssm_state"], H * P


def leaves(m):
    """[(path, shape, init, dtype)] in the port's layout; ``init`` is
    ("normal", scale), ("ones",), ("const", c), ("mamba_A",) or
    ("mamba_dt",), ``dtype`` "param" (the configuration's) or "float32".
    The norms' scales start at 0: a gain of 1 under the (1 + scale)
    convention (the port's ``init_params`` sets them to 1, a gain of 2
    at every norm, under which bf16 rounding grows with depth until
    zamba2-2.7b's last logits lie 40-50% from float32's)."""
    d, V = m["d_model"], m["vocab"]
    H, P, N, d_in = ssm_dims(m)
    hd = m.get("head_dim") or d // m["n_heads"]
    nh, kv, f = m["n_heads"], m.get("n_kv_heads") or m["n_heads"], m["d_ff"]

    def dense(path, rows, cols, scale=None):
        return (path, (rows, cols), ("normal", scale or 1 / math.sqrt(rows)),
                "param")
    out = [(("embed",), (V, d), ("normal", 0.02), "param"),
           (("final_norm",), (d,), GAIN, "param")]
    for i in range(m["n_layers"]):
        lay = ("layers", i)
        out += [
            dense(lay + ("w_in",), d, 2 * d_in + 2 * N + H),
            (lay + ("conv_w",), (m["ssm_conv"], d_in + 2 * N),
             ("normal", 0.5), "param"),
            (lay + ("A_log",), (H,), ("mamba_A",), "float32"),
            (lay + ("D",), (H,), ("ones",), "param"),
            (lay + ("dt_bias",), (H,), ("mamba_dt",), "float32"),
            dense(lay + ("w_out",), d_in, d),
            (lay + ("norm",), (d,), GAIN, "param"),
            (lay + ("gate_norm",), (d_in,), GAIN, "param")]
    sh = ("shared",)
    out += [dense(sh + ("attn", "wq"), d, nh * hd),
            dense(sh + ("attn", "wk"), d, kv * hd),
            dense(sh + ("attn", "wv"), d, kv * hd),
            dense(sh + ("attn", "wo"), nh * hd, d),
            dense(sh + ("mlp", "w_up"), d, f),
            dense(sh + ("mlp", "w_down"), f, d),
            dense(sh + ("mlp", "w_gate"), d, f),
            (sh + ("norm1",), (d,), GAIN, "param"),
            (sh + ("norm2",), (d,), GAIN, "param")]
    return out


def stacked_key(path) -> str:
    """The optimizer leaf a weight belongs to: per-layer weights stacked
    under ``mamba/``, the shared block's under ``shared_<part>/``."""
    if path[0] == "layers":
        return "mamba/" + path[2]
    if path[0] == "shared":
        return "/".join(("shared_" + path[1],) + tuple(path[2:]))
    return "/".join(path)


def mamba_layer(x, p, m):
    B, S, _ = x.shape
    H, P, N, d_in = ssm_dims(m)
    z = C.matmul(C.act(C.rms_norm(x, p["norm"])), p["w_in"])
    xin, gate, Bv, Cv, dt = torch.split(z, [d_in, d_in, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bv, Cv], dim=-1)
    K = p["conv_w"].shape[0]
    xp = F.pad(conv_in, (0, 0, K - 1, 0))
    conv = C.act(C.silu(sum(xp[:, i:i + S] * p["conv_w"][i]
                            for i in range(K))))
    xin, Bv, Cv = torch.split(conv, [d_in, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    y = C.act(ssd(xin.reshape(B, S, H, P), dt, p["A_log"], Bv, Cv, p["D"],
                  chunk=SSD_CHUNK))
    y = C.act(C.rms_norm(y.reshape(B, S, d_in), p["gate_norm"])
              * C.silu(gate))
    return C.act(x + C.matmul(y, p["w_out"]))


def shared_block(h, p, m):
    B, S, d = h.shape
    nh = m["n_heads"]
    kv = m.get("n_kv_heads") or nh
    hd = m.get("head_dim") or d // nh
    a = p["attn"]
    x = C.act(C.rms_norm(h, p["norm1"]))
    pos = torch.arange(S, device=h.device)
    theta = m.get("rope_theta", 10000.0)
    q = C.act(C.rope(C.matmul(x, a["wq"]).reshape(B, S, nh, hd), pos, theta))
    k = C.act(C.rope(C.matmul(x, a["wk"]).reshape(B, S, kv, hd), pos, theta))
    v = C.matmul(x, a["wv"]).reshape(B, S, kv, hd)
    o = C.act(C.causal_attention(q, k, v)).reshape(B, S, nh * hd)
    h = C.act(h + C.matmul(o, a["wo"]))
    x = C.act(C.rms_norm(h, p["norm2"]))
    mp = p["mlp"]
    up = C.act(C.silu(C.matmul(x, mp["w_gate"])) * C.matmul(x, mp["w_up"]))
    return C.act(h + C.matmul(up, mp["w_down"]))


def hidden(P, m, tokens):
    """The last hidden states (B, S, d) of ``tokens`` (B, S)."""
    h = C.act(P["embed"][tokens.long()] * math.sqrt(m["d_model"]))
    k = m["shared_attn_every"]
    for g in range(m["n_layers"] // k):
        for lp in P["layers"][g * k:(g + 1) * k]:
            h = C.remat(lambda h, lp=lp: mamba_layer(h, lp, m), h)
        h = C.remat(lambda h: shared_block(h, P["shared"], m), h)
    return h


def head(P, h):
    return C.matmul(C.act(C.rms_norm(h, P["final_norm"])), P["embed"].T)


def forward(P, m, tokens):
    """Logits (B, S, V) of ``tokens`` (B, S)."""
    return head(P, hidden(P, m, tokens))


def last_logits(P, m, tokens):
    """Logits (B, V) at the last position of ``tokens`` (B, S)."""
    return head(P, hidden(P, m, tokens)[:, -1])
