"""Least work of one RWKV-6 WKV call and of its backward, from shapes
(frozen copies of ``chip_smoke.py``'s ``wkv_bound`` and ``wkv_bwd_bound``,
with the chunk length ``kernels/rwkv6/ops.py``'s ``CHUNK`` had when they
were frozen)."""
from portbench.work.peaks import roofline

CHUNK = 32


def _lens(S):
    return [min(CHUNK, S - s0) for s0 in range(0, S, CHUNK)]


def wkv_bound(B, S, H, K, dtype):
    """Least time for one WKV call: per (batch, head) and chunk of l steps,
    (r exp(cum_ex)) S and the state update (2 l K^2 multiply-adds), a and
    a v over the l (l - 1) / 2 causal pairs (K each), and the bonus (2 l K),
    at 2 flops a multiply-add over the peak rate of ``dtype``; against r,
    k, v, u read once in ``dtype``, log_w in f32 and o written once over
    HBM's rate.  Returns (ms, bound_by, flops, bytes)."""
    item = 2 if dtype == "bfloat16" else 4
    flops = sum(B * H * 2 * (2 * ln * K * K + K * ln * (ln - 1) + 2 * ln * K)
                for ln in _lens(S))
    nbytes = 4 * item * B * S * H * K + 4 * B * S * H * K + item * H * K
    return (*roofline(flops, nbytes, dtype), flops, nbytes)


def wkv_bwd_bound(B, S, H, K, dtype):
    """Least time for one WKV backward call: per (batch, head) and chunk of
    l steps, the state recomputed, do S_c^T, (r exp(cum_ex))^T do, v dS^T
    and kdec dS (2 l K^2 each), A, dA, A^T do and the two sums over E over
    the l (l - 1) / 2 causal pairs (2 K each), and the bonus's five terms
    (2 l K each), over the peak rate of ``dtype``; against r, k, v, do, u
    read once in ``dtype`` and log_w in f32, and their gradients written
    once, over HBM's rate.  Returns (ms, bound_by, flops, bytes)."""
    item = 2 if dtype == "bfloat16" else 4
    flops = sum(B * H * (5 * 2 * ln * K * K + 5 * K * ln * (ln - 1)
                         + 5 * 2 * ln * K) for ln in _lens(S))
    nbytes = (7 * item * B * S * H * K + 2 * 4 * B * S * H * K
              + 2 * item * H * K)
    return (*roofline(flops, nbytes, dtype), flops, nbytes)
