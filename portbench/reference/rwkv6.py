"""The rwkv6 family in plain PyTorch, float32: the layout and initial
values of its weights (the port's parameter layout), its forward pass and
the names of its optimizer leaves.

    embed -> RWKV-6 blocks -> final RMSNorm -> tied logits

Block: RMSNorm; time mix: static token-shift mixes (sigmoid of ``mix``) of
the normed input and its predecessor into r, k, v, the decay and g; r, k,
v, g = SiLU(.) projections, log w = max(-exp(x ww + w_bias), -8); the WKV
(``scans.wkv``, bonus ``u``); an RMSNorm of its output gated by g, the
output projection, the residual; channel mix: RMSNorm, relu(x ffn_k)^2
ffn_v gated by sigmoid(shifted x ffn_r), the residual.  Its departures
from the published RWKV-6 are listed in ``configs/rwkv6-1.6b.json``."""
from __future__ import annotations

import math

import torch

from portbench.reference import common as C
from portbench.reference.common import GAIN
from portbench.reference.scans import wkv

LOG_W_MIN = -8.0


def leaves(m):
    """[(path, shape, init, dtype)] in the port's layout (see
    ``zamba2.leaves``: the norms' scales start at 0, a gain of 1)."""
    d, f, V = m["d_model"], m["d_ff"], m["vocab"]
    s = 1 / math.sqrt(d)
    out = [(("embed",), (V, d), ("normal", 0.02), "param"),
           (("final_norm",), (d,), GAIN, "param")]
    for i in range(m["n_layers"]):
        lay = ("layers", i)
        out += [
            (lay + ("mix",), (5, d), ("normal", 0.5), "param"),
            (lay + ("wr",), (d, d), ("normal", s), "param"),
            (lay + ("wk",), (d, d), ("normal", s), "param"),
            (lay + ("wv",), (d, d), ("normal", s), "param"),
            (lay + ("wg",), (d, d), ("normal", s), "param"),
            (lay + ("ww",), (d, d), ("normal", 0.01), "param"),
            (lay + ("w_bias",), (d,), ("const", -5.0), "param"),
            (lay + ("u",), (d,), ("normal", 0.5), "param"),
            (lay + ("wo",), (d, d), ("normal", s), "param"),
            (lay + ("ln_x",), (d,), GAIN, "param"),
            (lay + ("ffn_k",), (d, f), ("normal", s), "param"),
            (lay + ("ffn_v",), (f, d), ("normal", 1 / math.sqrt(f)),
             "param"),
            (lay + ("ffn_r",), (d, d), ("normal", s), "param"),
            (lay + ("norm1",), (d,), GAIN, "param"),
            (lay + ("norm2",), (d,), GAIN, "param")]
    return out


def stacked_key(path) -> str:
    """The optimizer leaf a weight belongs to: per-layer weights stacked
    under ``rwkv/``."""
    if path[0] == "layers":
        return "rwkv/" + path[2]
    return "/".join(path)


def block(x, p, m):
    B, S, d = x.shape
    H = m["n_heads"]
    K = d // H
    h = C.act(C.rms_norm(x, p["norm1"]))
    mix = torch.sigmoid(p["mix"])
    hs = C.shift(h)

    def mixed(i):
        return C.act(h * mix[i] + hs * (1.0 - mix[i]))
    r = C.matmul(mixed(0), p["wr"])
    k = C.matmul(mixed(1), p["wk"])
    v = C.matmul(mixed(2), p["wv"])
    lw = C.matmul(mixed(3), p["ww"]) + p["w_bias"]
    g = C.act(C.silu(C.matmul(mixed(4), p["wg"])))
    log_w = (-torch.exp(lw)).clamp_min(LOG_W_MIN)
    o = C.act(wkv(r.reshape(B, S, H, K), k.reshape(B, S, H, K),
                  v.reshape(B, S, H, K), log_w.reshape(B, S, H, K),
                  p["u"].reshape(H, K)).reshape(B, S, d))
    x = C.act(x + C.matmul(C.act(C.rms_norm(o, p["ln_x"]) * g), p["wo"]))
    h2 = C.act(C.rms_norm(x, p["norm2"]))
    kk = C.act(torch.square(torch.relu(C.matmul(h2, p["ffn_k"]))))
    rr = C.act(torch.sigmoid(C.matmul(C.shift(h2), p["ffn_r"])))
    return C.act(x + rr * C.matmul(kk, p["ffn_v"]))


def hidden(P, m, tokens):
    h = C.act(P["embed"][tokens.long()] * math.sqrt(m["d_model"]))
    for lp in P["layers"]:
        h = C.remat(lambda h, lp=lp: block(h, lp, m), h)
    return h


def head(P, h):
    return C.matmul(C.act(C.rms_norm(h, P["final_norm"])), P["embed"].T)


def forward(P, m, tokens):
    return head(P, hidden(P, m, tokens))


def last_logits(P, m, tokens):
    return head(P, hidden(P, m, tokens)[:, -1])
