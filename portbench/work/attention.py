"""Least work of one attention call and of its backward, from shapes
(frozen copies of ``chip_smoke.py``'s ``attention_pairs``,
``attention_bound`` and ``attention_bwd_bound``)."""
from portbench.work.peaks import roofline


def attention_pairs(Sq, Skv, causal, window, prefix_len=0) -> int:
    """The (query, key) pairs the mask keeps, per batch row and head (a
    causal query also sees the keys before ``prefix_len``)."""
    total = 0
    for q in range(Sq):
        lo = max(q - window + 1, 0) if window > 0 else 0
        hi = min(max(q, prefix_len - 1), Skv - 1) if causal else Skv - 1
        total += max(hi - lo + 1, 0)
    return total


def attention_bound(B, Sq, Skv, H, KV, D, dtype, causal, window,
                    prefix_len=0):
    """Least time for one attention call: 4 * D flops per (query, key)
    pair the mask keeps, over the peak rate of ``dtype``, against q, k, v
    read once and the output written once over HBM's rate.  Returns (ms,
    bound_by, flops, bytes)."""
    pairs = attention_pairs(Sq, Skv, causal, window, prefix_len)
    flops = 4 * D * pairs * B * H
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
    return (*roofline(flops, nbytes, dtype), flops, nbytes)


def attention_bwd_bound(B, S, H, KV, D, dtype, causal, window, prefix_len=0):
    """Least time for one backward call: 10 * D flops per kept pair (S
    again, dP, dV, dS K, dS^T Q) over the peak rate of ``dtype``, against
    q, o, dO, dQ, k, v, dK, dV read or written once and the f32 lse.
    Returns (ms, bound_by, flops, bytes)."""
    pairs = attention_pairs(S, S, causal, window, prefix_len)
    flops = 10 * D * pairs * B * H
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (4 * B * S * H * D + 4 * B * S * KV * D) + 4 * B * H * S
    return (*roofline(flops, nbytes, dtype), flops, nbytes)
