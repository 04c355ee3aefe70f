"""What one launch of each hand-written kernel costs, for the dry-run's
trace (``analysis/hlo_cost``).

On ``meta`` tensors the models run the kernels' plain versions
(``blockwise_attention``, ``ssd_chunked``, ``wkv6_chunked``), whose ops
are not the program the card runs: the plain attention alone writes and
reads every score block.  ``as_kernel`` runs the plain version so that an
active ``CostModel`` counts one launch of the kernel instead, and, under
autograd, one launch of its backward kernel for the gradient:

  * FLOPs: the least products the function needs on these shapes (the
    pairs the attention mask keeps, the scans' causal pairs within a chunk),
    as ``chip_smoke.py``'s ``*_bound`` count them;
  * bytes: each input read once and each output written once (the
    backward: the inputs, the output's gradient and, for attention, the
    output and the f32 row statistics read, and the inputs' gradients
    written).

So the trace's terms bound the program that runs on the card.  Without a
``CostModel`` (the CPU's plain path, a ``meta`` run outside the dry-run)
``as_kernel`` is the plain call.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

#: (forward FLOPs, forward bytes, backward FLOPs, backward bytes)
Cost = Tuple[float, float, float, float]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int,
                    prefix_len: int = 0) -> int:
    """The (query, key) pairs the mask keeps, per batch row and head
    (``window`` 0: none; a causal query also sees the keys before
    ``prefix_len``)."""
    q = torch.arange(Sq, dtype=torch.int64)
    lo = (q - window + 1).clamp_min(0) if window > 0 else torch.zeros_like(q)
    hi = (q.clamp_min(prefix_len - 1).clamp_max(Skv - 1) if causal
          else torch.full_like(q, Skv - 1))
    return int((hi - lo + 1).clamp_min(0).sum())


def flash_cost(q, k, v, *, causal: bool, window: int,
               prefix_len: int = 0) -> Cost:
    """The flash kernel and its backward on q (B, Sq, H, D), k and v (B,
    Skv, KV, D): 4 D FLOPs a kept pair forward (Q K^T, P V), 10 D backward
    (S again, dP, dV, dQ, dK)."""
    B, Sq, H, D = q.shape
    pairs = attention_pairs(Sq, k.shape[1], causal, window, prefix_len)
    io = _nbytes(q, k, v)
    out = _nbytes(q)
    lse = 4 * B * H * Sq
    return (4 * D * pairs * B * H, io + out,
            10 * D * pairs * B * H, 2 * io + 2 * out + lse)


def _chunks(S: int, chunk: int):
    return [min(chunk, S - s0) for s0 in range(0, S, chunk)]


def ssd_cost(x, dt, A_log, B, C, D) -> Cost:
    """The SSD kernel and its backward on x (B, S, H, P), dt (B, S, H), B
    and C (B, S, N): per chunk of l steps, C B^T over the causal pairs
    once per batch row, and per head C S^T, W x and the state update
    (forward); the state recomputed, five l P N products, two over the
    causal pairs per head and three per batch row (backward)."""
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    lens = _chunks(S, CHUNK)
    pairs = [ln * (ln + 1) // 2 for ln in lens]
    fwd = sum(Bsz * (2 * N * pr + H * (4 * ln * P * N + 2 * P * pr))
              for ln, pr in zip(lens, pairs))
    bwd = sum(Bsz * H * (10 * ln * P * N + 4 * P * pr) + Bsz * 6 * N * pr
              for ln, pr in zip(lens, pairs))
    io = _nbytes(x, dt, A_log, B, C, D)
    out = _nbytes(x)
    return fwd, io + out, bwd, 2 * io + out


def wkv_cost(r, k, v, log_w, u) -> Cost:
    """The WKV kernel and its backward on r, k, v, log_w (B, S, H, K): per
    (batch, head) and chunk of l steps, 2 l K^2 of state, K a causal pair
    and 2 l K of bonus, twice forward (2 FLOPs a multiply-add) and five
    times backward."""
    from repro_torch.kernels.rwkv6.ops import CHUNK
    Bsz, S, H, K = r.shape
    lens = _chunks(S, CHUNK)
    pass_ = sum(Bsz * H * (2 * ln * K * K + K * ln * (ln - 1) + 2 * ln * K)
                for ln in lens)
    io = _nbytes(r, k, v, log_w, u)
    out = _nbytes(r)
    return 2 * pass_, io + out, 5 * pass_, 2 * io + out


def _active_model():
    """The ``CostModel`` tracing this step, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from repro_torch.analysis.hlo_cost import CostModel
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostModel):
            return mode
    return None


class _Launch(torch.autograd.Function):
    """The plain version run as one kernel launch each way."""

    @staticmethod
    def forward(ctx, name, fn, cost, *inputs):
        ctx.name, ctx.fn, ctx.cost = name, fn, cost
        ctx.save_for_backward(*inputs)
        model = _active_model()
        with model.kernel(name, cost[0], cost[1]) as held:
            out = fn(*inputs)
            held.append(out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        model = _active_model()
        with model.kernel(ctx.name + "_bwd", ctx.cost[2],
                          ctx.cost[3]) as held:
            with torch.enable_grad():
                live = [t.detach().requires_grad_(need) for t, need in
                        zip(inputs, ctx.needs_input_grad[3:])]
                wanted = [t for t in live if t.requires_grad]
                grads = iter(torch.autograd.grad(
                    ctx.fn(*live), wanted, grad_out, allow_unused=True))
            out = [next(grads) if t.requires_grad else None for t in live]
            held.append([g for g in out if g is not None])
        return (None, None, None, *out)


def as_kernel(name: str, fn: Callable, cost: Callable[..., Cost], *inputs):
    """``fn(*inputs)``, the plain version of kernel ``name``, counted by the
    active ``CostModel`` as one launch of the kernel (``cost(*inputs)``:
    its FLOPs and bytes each way) rather than as its own ops; the plain
    call itself when no ``CostModel`` is active."""
    if _active_model() is None:
        return fn(*inputs)
    return _Launch.apply(name, fn, cost(*inputs), *inputs)


__all__ = ("as_kernel", "attention_pairs", "flash_cost", "ssd_cost",
           "wkv_cost")
