"""Model FLOPs of the rwkv6 family, from the configuration's weight shapes:
2 per multiply-add of every weight product (the five time-mix projections
and the output, the channel mix's three, the tied output head; the
embedding gather not), plus the WKV's least products (``work/wkv.py``).
Nothing is read from the program."""
from portbench.work.wkv import wkv_bound


def weight_macs_per_token(m) -> int:
    d, f = m["d_model"], m["d_ff"]
    layer = 6 * d * d + 2 * d * f + d * d
    return m["n_layers"] * layer + d * m["vocab"]


def forward_flops(m, B: int, S: int) -> int:
    """Forward FLOPs of B sequences of S tokens."""
    H = m["n_heads"]
    K = m["d_model"] // H
    scan = wkv_bound(B, S, H, K, "bfloat16")[2]
    return 2 * weight_macs_per_token(m) * B * S + m["n_layers"] * scan
