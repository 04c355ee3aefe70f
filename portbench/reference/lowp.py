"""The control: the reference computed in fp8 where the configuration
computes in bfloat16, the step below it that would tempt a later change:
every weight product's operands and result, and every activation the
model keeps between operations (``common.act``: the embedding, the norms'
outputs, the gates, the scans' outputs, the residual stream), rounded to
e4m3 with one scale per tensor from its largest magnitude.  What the
configuration keeps in f32 (dt, the decays, the scans' states, the loss)
stays f32.  The rounding passes gradients straight through."""
from __future__ import annotations

import contextlib

import torch

from portbench.reference import common

E4M3_MAX = 448.0


def fp8(x):
    """x rounded through float8_e4m3fn with a per-tensor scale; the
    gradient passes unchanged."""
    with torch.no_grad():
        s = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def fp8_matmul(a, b):
    return fp8(fp8(a) @ fp8(b))


@contextlib.contextmanager
def fp8_products():
    """Within the block, the reference computes in fp8."""
    saved = common.matmul, common.act
    common.matmul, common.act = fp8_matmul, fp8
    try:
        yield
    finally:
        common.matmul, common.act = saved
