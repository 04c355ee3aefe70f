"""The port's flash attention against the JAX package's.

On the CPU: the plain versions (``flash_attention_torch``, the kernel's
blocked online softmax, and ``attention_ref``) against the reference's
Pallas kernel in interpret mode and its oracle, on the same inputs made
with numpy, over the sweep of ``tests/test_kernels.py`` in f32 and bf16
(tolerances 2e-3 and 5e-2, the reference's own), the prefix-LM mask
(``prefix_len``, which the reference computes in ``blockwise_attention``
only) against that function, and an emulation of the bf16 kernel's
rounding against the bound the kernel is held to.  On a card
(``cuda`` marker, skipped without one): the hand-written kernel (bf16: the
tensor-core form; f32: the CUDA-core form) against its plain version;
those tests import nothing of JAX, so they also run where only the port is
installed:

    python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_torch)
from repro_torch.models.layers import GLOBAL_WINDOW, blockwise_attention

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
#: the kernel against its plain version, (atol, rtol).  f32: the
#: reference's 2e-3.  bf16: the kernel's f32 result agrees with the plain
#: one to about 1e-5 (P enters P V as two bf16 terms, 16 bits), so the two
#: bf16 outputs differ by at most one ulp, 2^-7 |want| < 1e-2 |want|
#: (chip_smoke.py holds the same bound)
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
    got = flash_attention_torch(q, k, v, causal=causal, window=window,
                                prefix_len=0, bk=64)
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
    layer and the window itself otherwise, and ``prefix_len or 0``; in the
    kernel's arithmetic that is the mask ``blockwise_attention`` applies,
    with no prefix, one inside the tiles and one past the end."""
    q, k, v = _inputs((2, 96, 96, 8, 2, 16), torch.float32, seed=3)
    for prefix_len in (None, 40, 99):
        got = flash_attention_torch(
            q, k, v, causal=causal,
            window=0 if window >= GLOBAL_WINDOW else window,
            prefix_len=prefix_len or 0)
        want = blockwise_attention(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, block_kv=32)
        _close(got, want, torch.float32)


#: (B, S, H, KV, D): GQA and MQA (paligemma's one KV head)
PREFIX_SHAPES = [(2, 37, 8, 2, 16), (1, 40, 4, 1, 32)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", PREFIX_SHAPES,
                         ids=lambda s: "B{}-S{}-H{}-KV{}-D{}".format(*s))
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("extra", [1, 5, 0, 3], ids=["P1", "P5", "PS",
                                                     "PS+3"])
def test_prefix_lm_matches_reference_blockwise(reference, extra, causal,
                                               window, shape, dtype):
    """``prefix_len`` = P in the plain version and the wrapper's CPU branch
    against the reference's ``blockwise_attention(prefix_len=P)``: every
    key before P is seen by every query when causal, P is ignored when
    not; P = 1, 5, S and S + 3 (``extra`` 0 and 3 are added to S)."""
    _, _, to_jax = reference
    from repro.models.layers import blockwise_attention as ref_blockwise
    B, S, H, KV, D = shape
    P = extra if extra in (1, 5) else S + extra
    q, k, v = _inputs((B, S, S, H, KV, D), dtype, seed=17)
    want = ref_blockwise(to_jax(q), to_jax(k), to_jax(v), causal=causal,
                         window=window or GLOBAL_WINDOW, prefix_len=P,
                         block_kv=16)
    plain = flash_attention_torch(q, k, v, causal=causal, window=window,
                                  prefix_len=P, bk=16)
    wrapped = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  prefix_len=P)
    assert plain.dtype == wrapped.dtype == dtype
    assert torch.equal(wrapped, flash_attention_torch(
        q, k, v, causal=causal, window=window, prefix_len=P))
    for got in (plain, wrapped,
                attention_ref(q, k, v, causal=causal, window=window,
                              prefix_len=P)):
        _close(got.float(), want.astype("float32"), dtype)
    if causal and window == 0 and P > 1:
        # the prefix is seen (P = 1 is causal attention itself): row 0
        # differs from plain causal attention
        causal_only = attention_ref(q, k, v, causal=True)
        assert not torch.allclose(plain[:, 0].float(),
                                  causal_only[:, 0].float(), atol=0.1)


def kernel_rounding(q, k, v, *, causal=True, bk=128):
    """The bf16 tensor-core form's arithmetic on the CPU: scores (q . k) in
    f32, scaled into log2 units, an online softmax over tiles of ``bk`` keys
    in exp2, P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), each
    multiplied by V with f32 sums, l summed from the f32 P, the output
    rounded once to bf16."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B, H, S, D)
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (k, v))
    c = torch.tensor((1.0 / math.sqrt(D)) * math.log2(math.e),
                     dtype=torch.float32)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kp = torch.arange(k0, min(k0 + bk, S))[None, :]
        keep = qp >= kp if causal else torch.ones((S, kp.shape[1]), dtype=torch.bool)
        s = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * c
        s = torch.where(keep, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vb = vf[:, :, k0:k0 + bk]
        acc = acc * corr + hi @ vb + lo @ vb
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("D", [80, 128])
def test_kernel_rounding_meets_the_kernel_bound(D):
    """Why the bf16 kernel splits P: with P_hi + P_lo (16 bits of P) its
    arithmetic stays within ``KERNEL_TOL[bf16]`` of the plain version at
    the main path's length, causal, in every element (a P rounded once to
    bf16 leaves rare outputs outside it at the main path's full shape)."""
    q, k, v = _inputs((1, 2048, 2048, 4, 2, D), torch.bfloat16, seed=13)
    got = kernel_rounding(q, k, v, causal=True)
    want = flash_attention_torch(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


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
def test_wrapper_rejects_negative_prefix(causal):
    q, k, v = _inputs((1, 16, 16, 4, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="prefix_len"):
        ops.flash_attention(q, k, v, causal=causal, prefix_len=-1)


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
    ((2, 2048, 2048, 32, 8, 128), (True, 0)),   # qwen3-8b's prefill shape
    ((1, 127, 127, 4, 2, 128), (True, 0)),      # lengths at a 128-row tile
    ((1, 128, 128, 4, 2, 128), (True, 0)),
    ((1, 129, 129, 4, 2, 128), (True, 0)),
    ((1, 255, 255, 4, 2, 128), (True, 0)),
    ((1, 300, 300, 4, 2, 128), (True, 100)),    # window across a tile edge
    ((2, 300, 300, 32, 8, 128), (True, 0)),     # qwen3-8b heads, ragged
    ((1, 257, 257, 32, 8, 80), (True, 96)),     # danube-1.8b's head width
    ((1, 130, 130, 32, 8, 120), (True, 0)),     # danube-3-4b's head width
    ((1, 65, 65, 4, 2, 16), (False, 20)),       # smoke width, non-causal window
    ((1, 100, 100, 2, 1, 256), (True, 0)),      # the widest head
    ((1, 70, 70, 4, 2, 20), (True, 0)),         # bf16 pads it to 24 for TMA
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


#: (B, Sq, Skv, H, KV, D) x (causal, window, prefix_len)
CARD_PREFIX_CASES = [
    ((2, 2304, 2304, 8, 1, 256), (True, 0, 256)),  # paligemma-3b's prefill
    ((1, 300, 300, 8, 2, 128), (True, 0, 100)),    # ends inside a tile
    ((1, 200, 200, 4, 1, 256), (True, 0, 0)),      # D = 256 MQA, no prefix
    ((1, 300, 300, 4, 1, 256), (True, 0, 64)),     # a whole 64-key tile
    ((1, 257, 257, 4, 2, 80), (True, 0, 1)),       # causal itself
    ((1, 130, 130, 4, 2, 64), (True, 0, 130)),     # prefix = S
    ((1, 130, 130, 4, 2, 64), (True, 0, 500)),     # prefix past S
    ((1, 300, 300, 4, 2, 128), (True, 64, 200)),   # with a window
    ((1, 300, 300, 4, 2, 128), (False, 0, 100)),   # ignored: not causal
    ((2, 2048, 2048, 16, 16, 80), (False, 0, 0)),  # hubert-xlarge's prefill
]


def _prefix_ids(case):
    (B, Sq, Skv, H, KV, D), (causal, window, prefix_len) = case
    return (f"B{B}-Sq{Sq}-Skv{Skv}-H{H}-KV{KV}-D{D}-causal{int(causal)}"
            f"-w{window}-p{prefix_len}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_PREFIX_CASES, ids=_prefix_ids)
def test_kernel_matches_plain_version_with_prefix(card, case, dtype):
    shape, (causal, window, prefix_len) = case
    q, k, v = _inputs(shape, dtype, seed=23, device=card)
    before = ops.launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert ops.launches() == before + 1
    want = flash_attention_torch(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len)
    atol, rtol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_attention_block_sends_the_prefix_to_the_kernel(card, monkeypatch):
    """On a CUDA tensor, prefix-LM attention is one kernel launch and never
    the plain ``blockwise_attention``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import layers
    from repro_torch.models.common import init_attention

    def refuse(*args, **kw):
        raise AssertionError("blockwise_attention ran on the card")
    monkeypatch.setattr(layers, "blockwise_attention", refuse)
    cfg = smoke_config("paligemma-3b")
    p = init_attention(torch.Generator(device=card).manual_seed(0), cfg,
                       card, cfg.dtype)
    x = torch.randn((2, 20, cfg.d_model), device=card).to(cfg.dtype)
    positions = torch.arange(20, device=card)[None, :]
    before = ops.launches()
    out = layers.attention_block(x, p, cfg, positions, causal=True,
                                 prefix_len=cfg.n_prefix_tokens)
    torch.cuda.synchronize()
    assert ops.launches() == before + 1
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_bf16_kernel_rejects_a_misaligned_view(card):
    """The bf16 form's TMA reads from 16-byte aligned tensors: a contiguous
    view that starts off that alignment raises."""
    q, k, v = _inputs((1, 32, 32, 4, 4, 32), torch.bfloat16, device=card)
    shifted = torch.empty(q.numel() + 4, dtype=q.dtype, device=card)[4:]
    shifted = shifted.view(q.shape).copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(shifted, k, v)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_input(card):
    q, k, v = _inputs((1, 32, 32, 4, 4, 32), torch.float32, device=card)
    strided = torch.cat([q, q], dim=-1)[..., :32]
    assert strided.shape == q.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(strided, k, v)
