"""Model FLOPs of the zamba2 family, from the configuration's weight
shapes: 2 per multiply-add of every weight product at every application
(the shared attention + MLP block once per application, the depthwise conv
included, the tied output head included, the embedding gather not), plus
the shared attention's causal pairs and the SSD's least products
(``work/attention.py``, ``work/ssd.py``).  Nothing is read from the
program."""
from portbench.work.attention import attention_bound
from portbench.work.ssd import ssd_bound


def ssm_dims(m):
    """(H, P, N, d_in) of the Mamba-2 mixer: H = 2 d_model / P heads."""
    P = m["ssm_head_dim"]
    H = max(1, 2 * m["d_model"] // P)
    return H, P, m["ssm_state"], H * P


def weight_macs_per_token(m) -> int:
    """Multiply-adds a token of every weight product, each application
    counted."""
    d, V = m["d_model"], m["vocab"]
    H, P, N, d_in = ssm_dims(m)
    mamba = (d * (2 * d_in + 2 * N + H) + d_in * d
             + m["ssm_conv"] * (d_in + 2 * N))
    hd = m.get("head_dim") or d // m["n_heads"]
    kv = m.get("n_kv_heads") or m["n_heads"]
    attn = d * hd * (m["n_heads"] + 2 * kv) + m["n_heads"] * hd * d
    mlp = (3 if m.get("mlp_act", "silu") == "silu" else 2) * d * m["d_ff"]
    applications = m["n_layers"] // m["shared_attn_every"]
    return m["n_layers"] * mamba + applications * (attn + mlp) + d * V


def forward_flops(m, B: int, S: int) -> int:
    """Forward FLOPs of B sequences of S tokens."""
    H, P, N, _ = ssm_dims(m)
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    kv = m.get("n_kv_heads") or m["n_heads"]
    applications = m["n_layers"] // m["shared_attn_every"]
    attn = attention_bound(B, S, S, m["n_heads"], kv, hd, "bfloat16",
                           True, 0)[2]
    scan = ssd_bound(B, S, H, P, N, "bfloat16")[2]
    return (2 * weight_macs_per_token(m) * B * S + applications * attn
            + m["n_layers"] * scan)
