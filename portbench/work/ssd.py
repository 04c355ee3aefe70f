"""Least work of one Mamba-2 SSD call and of its backward, from shapes
(frozen copies of ``chip_smoke.py``'s ``ssd_bound`` and ``ssd_bwd_bound``,
with the chunk length the port's kernels used when they were frozen)."""
from portbench.work.peaks import roofline

#: the chunk length of the SSD kernels (``kernels/mamba2_ssd/ops.py``)
CHUNK = 64
#: the bf16 backward's full L^3 products per (batch, chunk)
SSD_BWD_PRODUCTS = {"per_boundary": 2 * 3,
                    "per_head": 1 + 2 + 2 + 2 + 2 + 3,
                    "per_group": 1 + 2 + 2}
SSD_BWD_GROUP = 8


def _lens(S):
    return [min(CHUNK, S - s0) for s0 in range(0, S, CHUNK)]


def ssd_bound(B, S, H, P, N, dtype):
    """Least time for one SSD call: per chunk of l steps, C B^T over the
    l (l + 1) / 2 causal pairs once per batch row (B and C are shared by
    the heads), and per head C S^T, W x over the causal pairs, and the
    state update, at 2 flops a multiply-add over the peak rate of
    ``dtype``; against x, dt, B, C, A_log, D read once and y written once
    over HBM's rate.  Returns (ms, bound_by, flops, kernel_flops, bytes);
    ``kernel_flops`` are the flops the kernel issues: seven full L^3
    products per (batch, head, chunk) in bf16, four in f32."""
    item = 2 if dtype == "bfloat16" else 4
    lens = _lens(S)
    flops = sum(B * (2 * N * ln * (ln + 1) // 2
                     + H * (2 * ln * P * N + 2 * P * ln * (ln + 1) // 2
                            + 2 * ln * P * N)) for ln in lens)
    L = CHUNK
    if dtype == "bfloat16":
        products = L * L * N + 2 * (L * P * N + L * L * P + P * L * N)
    else:
        products = L * L * N + 2 * L * P * N + L * L * P
    kernel_flops = len(lens) * B * H * 2 * products
    nbytes = (2 * item * B * S * H * P + 4 * B * S * H + 2 * item * B * S * N
              + 2 * 4 * H)
    return (*roofline(flops, nbytes, dtype), flops, kernel_flops, nbytes)


def ssd_bwd_bound(B, S, H, P, N, dtype):
    """Least time for one SSD backward call: per chunk of l steps, per head
    the state recomputed (x kdec^T B), dy S_c, (dy exp(cum))^T C, B dS^T
    and x dS (2 l P N each), dy x^T and W^T dy over the l (l + 1) / 2
    causal pairs (2 P each), and per batch row C B^T, dcb B and dcb^T C
    over the causal pairs (2 N each), over the peak rate of ``dtype``;
    against x, dy, dt, B, C, A_log, D read once and their gradients
    written once over HBM's rate.  Returns (ms, bound_by, flops,
    kernel_flops, bytes)."""
    item = 2 if dtype == "bfloat16" else 4
    lens = _lens(S)
    pairs = [ln * (ln + 1) // 2 for ln in lens]
    flops = sum(B * H * (5 * 2 * ln * P * N + 2 * 2 * P * pr)
                + B * 3 * 2 * N * pr for ln, pr in zip(lens, pairs))
    if dtype == "bfloat16":
        groups = -(-H // SSD_BWD_GROUP)
        products = B * (len(lens) * (H * SSD_BWD_PRODUCTS["per_head"]
                                     + groups * SSD_BWD_PRODUCTS["per_group"])
                        + (len(lens) - 1) * H
                        * SSD_BWD_PRODUCTS["per_boundary"])
    else:
        products = len(lens) * B * H * 10
    kernel_flops = products * 2 * CHUNK ** 3
    nbytes = (3 * item * B * S * H * P + 2 * 4 * B * S * H
              + 4 * item * B * S * N + 4 * 4 * H)
    return (*roofline(flops, nbytes, dtype), flops, kernel_flops, nbytes)
