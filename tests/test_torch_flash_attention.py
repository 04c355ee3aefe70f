"""The port's flash attention against the JAX package's.

On the CPU: the plain versions (``flash_attention_torch``, the kernel's
blocked online softmax, and ``attention_ref``) against the reference's
Pallas kernel in interpret mode and its oracle, on the same inputs made
with numpy, over the sweep of ``tests/test_kernels.py`` in f32 and bf16
(tolerances 2e-3 and 5e-2, the reference's own).  On a card (``cuda``
marker, skipped without one): the hand-written kernel against its plain
version; those tests import nothing of JAX, so they also run where only
the port is installed:

    python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_torch)
from repro_torch.models.layers import GLOBAL_WINDOW, blockwise_attention

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
#: the kernel against its plain version, (atol, rtol): both round f32
#: values that agree to about 1e-6, so in bf16 they differ by at most one
#: ulp, 2^-7 |want| < 1e-2 |want| (chip_smoke.py holds the same bound)
KERNEL_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]

# (B, Sq, Skv, H, KV, D) x (causal, window): the reference's sweep, less the
# causal cases with Sq != Skv that its oracle skips
SHAPES = [
    (1, 128, 128, 4, 4, 64),       # MHA, square
    (2, 64, 256, 8, 2, 32),        # GQA 4:1, cross lengths
    (1, 200, 200, 4, 1, 64),       # MQA, non-multiple of block
    (1, 32, 512, 4, 4, 128),       # long KV
]
MODES = [(True, 0), (True, 64), (False, 0)]
SWEEP = [(s, m) for s in SHAPES for m in MODES if not (m[0] and s[1] != s[2])]


def _ids(case):
    (B, Sq, Skv, H, KV, D), (causal, window) = case
    return f"B{B}-Sq{Sq}-Skv{Skv}-H{H}-KV{KV}-D{D}-causal{int(causal)}-w{window}"


def _inputs(shape, dtype, seed=42, device="cpu"):
    B, Sq, Skv, H, KV, D = shape
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Skv, KV, D), np.float32),
            rng.standard_normal((B, Skv, KV, D), np.float32))
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrs]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's Pallas op and oracle, and a torch -> jax bridge."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention_op
    from repro.kernels.flash_attention.ref import attention_ref as ref_oracle

    def to_jax(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    return flash_attention_op, ref_oracle, to_jax


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SWEEP, ids=_ids)
def test_plain_version_matches_pallas_interpret(reference, case, dtype):
    pallas_op, ref_oracle, to_jax = reference
    shape, (causal, window) = case
    q, k, v = _inputs(shape, dtype)
    got = flash_attention_torch(q, k, v, causal=causal, window=window, bk=64)
    want = pallas_op(to_jax(q), to_jax(k), to_jax(v), causal=causal,
                     window=window, bq=64, bk=64, interpret=True)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got.float(), want.astype("float32"), dtype)
    _close(got.float(), attention_ref(q, k, v, causal=causal,
                                      window=window).float(), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SWEEP, ids=_ids)
def test_attention_ref_matches_reference_oracle(reference, case, dtype):
    _, ref_oracle, to_jax = reference
    shape, (causal, window) = case
    q, k, v = _inputs(shape, dtype, seed=7)
    got = attention_ref(q, k, v, causal=causal, window=window)
    want = ref_oracle(to_jax(q), to_jax(k), to_jax(v), causal=causal,
                      window=window)
    _close(got.float(), want.astype("float32"), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 8, 64])
def test_kernel_window_convention_matches_blockwise(causal, window):
    """``attention_block`` hands the kernel ``window = 0`` for a global
    layer and the window itself otherwise; in the kernel's arithmetic that
    is the mask ``blockwise_attention`` applies."""
    q, k, v = _inputs((2, 96, 96, 8, 2, 16), torch.float32, seed=3)
    got = flash_attention_torch(q, k, v, causal=causal,
                                window=0 if window >= GLOBAL_WINDOW else window)
    want = blockwise_attention(q, k, v, causal=causal, window=window,
                               block_kv=32)
    _close(got, want, torch.float32)


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing():
    q, k, v = _inputs((1, 70, 70, 4, 2, 32), torch.bfloat16, seed=5)
    before = ops.launches()
    got = ops.flash_attention(q, k, v, causal=True, window=16)
    assert ops.launches() == before
    assert torch.equal(got, flash_attention_torch(q, k, v, causal=True,
                                                  window=16))


@pytest.mark.parametrize("change,match", [
    (lambda q, k, v: (q[0], k, v), "4-D"),
    (lambda q, k, v: (q, k, v[:, :-1]), "differ"),
    (lambda q, k, v: (q[..., :8], k, v), "differ"),
    (lambda q, k, v: (q[:, :, :3], k, v), "H % KV"),
    (lambda q, k, v: (q, k.double(), v), "dtype"),
    (lambda q, k, v: (q.half(), k.half(), v.half()), "dtype"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    q, k, v = _inputs((1, 16, 16, 4, 2, 16), torch.float32)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(*change(q, k, v))


def test_wrapper_rejects_negative_window():
    q, k, v = _inputs((1, 16, 16, 4, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_rejects_a_window_that_leaves_a_row_no_key(causal):
    """Query row qp sees no key once qp >= Skv - 1 + window; the wrapper
    refuses such calls on every device, and takes the last window that
    still leaves every row a key."""
    q, _, _ = _inputs((1, 16, 16, 4, 2, 16), torch.float32)
    _, k, v = _inputs((1, 16, 8, 4, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(q, k, v, causal=causal, window=8)
    got = ops.flash_attention(q, k, v, causal=causal, window=9)
    assert torch.equal(got, flash_attention_torch(q, k, v, causal=causal,
                                                  window=9))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernel has no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


CARD_CASES = SWEEP + [
    ((2, 300, 300, 32, 8, 128), (True, 0)),     # qwen3-8b heads, ragged
    ((1, 257, 257, 32, 8, 80), (True, 96)),     # danube-1.8b's head width
    ((1, 130, 130, 32, 8, 120), (True, 0)),     # danube-3-4b's head width
    ((1, 65, 65, 4, 2, 16), (False, 20)),       # smoke width, non-causal window
    ((1, 100, 100, 2, 1, 256), (True, 0)),      # the widest head
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids)
def test_kernel_matches_plain_version(card, case, dtype):
    shape, (causal, window) = case
    q, k, v = _inputs(shape, dtype, seed=11, device=card)
    before = ops.launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches() == before + 1
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_input(card):
    q, k, v = _inputs((1, 32, 32, 4, 4, 32), torch.float32, device=card)
    strided = torch.cat([q, q], dim=-1)[..., :32]
    assert strided.shape == q.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(strided, k, v)
