"""The gradient of the port's flash attention against the JAX package's.

The reference has no backward kernel: its gradient of attention is XLA's
autodiff of ``blockwise_attention``.  On the CPU, on the same numpy inputs:
``flash_attention_bwd_torch`` (the backward kernel's plain version: P
recomputed from the forward's log-sum-exp, then D and dS) and the CPU
route of ``FlashAttentionFn`` (what ``flash_attention`` runs when an input
requires grad) against ``jax.vjp`` of ``blockwise_attention``, over causal,
windowed, prefix-LM and full masks, GQA and MQA, ragged lengths, f32 and
bf16 (tolerances 2e-3 and 5e-2, those of ``tests/test_kernels.py``); a
``gradcheck`` of the Function in f64; the routing (the Function only under
grad); and the bf16 tensor-core form's roundings (P and dS split into bf16
hi + lo) emulated at one KV group of h2o-danube-1.8b's training shape,
within the card's bound of the plain version, with each split shown to be
needed and a planted fault (dS without Drow) shown to fail.  On a card
(``cuda`` marker, skipped without one): the backward kernel against its
plain version (per element 2e-3 + 2e-3 |want| in f32, 2e-3 + 1e-2 |want|
in bf16, the bound ``chip_smoke.py`` holds), two calls giving the same
bits, ``lm_loss`` backward on a dense smoke model giving every attention
weight the plain path's gradient.  The card tests import nothing of JAX:

    python -m pytest -q -m cuda tests/test_torch_flash_attention_bwd.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (_keep,
                                                     flash_attention_bwd_torch,
                                                     flash_attention_torch)

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
KERNEL_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]
#: (B, Sq, Skv, H, KV, D)
SHAPES = [
    (1, 67, 67, 4, 2, 16),        # GQA 2:1, ragged
    (2, 45, 45, 4, 1, 32),        # MQA, ragged
    (1, 32, 96, 4, 4, 16),        # MHA, more keys than queries
]
#: (causal, window, prefix_len)
MODES = [(True, 0, 0), (True, 9, 0), (True, 0, 13), (True, 20, 13),
         (False, 0, 0)]
SWEEP = [(s, m) for s in SHAPES for m in MODES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tests run many small ops; with several test processes on the
    machine, torch's intra-op threads only contend.  One thread for this
    module, the previous count restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ids(case):
    (B, Sq, Skv, H, KV, D), (causal, window, prefix) = case
    return (f"B{B}-Sq{Sq}-Skv{Skv}-H{H}-KV{KV}-D{D}-causal{int(causal)}"
            f"-w{window}-p{prefix}")


def _inputs(shape, dtype, seed=3, device="cpu"):
    """q, k, v and an output gradient, made with numpy."""
    B, Sq, Skv, H, KV, D = shape
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Skv, KV, D), np.float32),
            rng.standard_normal((B, Skv, KV, D), np.float32),
            rng.standard_normal((B, Sq, H, D), np.float32))
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrs]


@pytest.fixture(scope="module")
def reference_vjp():
    """dq, dk, dv of the reference's ``blockwise_attention`` by
    ``jax.vjp``, as f32 numpy."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.layers import blockwise_attention

    def run(q, k, v, do, causal, window, prefix):
        def to_jax(t):
            a = jnp.asarray(t.float().numpy())
            return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

        def f(q, k, v):
            return blockwise_attention(
                q, k, v, causal=causal, window=window or (1 << 30),
                prefix_len=prefix or None, block_kv=32)
        _, vjp = jax.vjp(f, to_jax(q), to_jax(k), to_jax(v))
        return [np.asarray(g, np.float32) for g in vjp(to_jax(do))]
    return run


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SWEEP, ids=_ids)
def test_gradient_matches_reference_autodiff(reference_vjp, case, dtype):
    """Both routes on one reference run: the plain backward (over blocks
    of 16 keys, so that ragged blocks occur) and the Function's."""
    shape, (causal, window, prefix) = case
    q, k, v, do = _inputs(shape, dtype)
    mask = {"causal": causal, "window": window, "prefix_len": prefix}
    o, lse = flash_attention_torch(q, k, v, return_lse=True, bk=16, **mask)
    plain = flash_attention_bwd_torch(q, k, v, o, do, lse, bk=16, **mask)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, **mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    function = torch.autograd.grad(out, leaves, do)
    want = reference_vjp(q, k, v, do, causal, window, prefix)
    for route, got in (("plain", plain), ("function", function)):
        for name, g, w, t in zip("qkv", got, want, (q, k, v)):
            assert g.dtype == dtype and g.shape == t.shape
            np.testing.assert_allclose(g.float().numpy(), w,
                                       atol=TOL[dtype], rtol=TOL[dtype],
                                       err_msg=f"{route} d{name}")


#: the gradcheck's masks, scaled to its 11 positions
GRADCHECK_MODES = [(True, 0, 0), (True, 4, 0), (True, 0, 5), (True, 6, 5),
                   (False, 0, 0)]


@pytest.mark.parametrize("mode", GRADCHECK_MODES,
                         ids=lambda m: f"c{int(m[0])}-w{m[1]}-p{m[2]}")
def test_function_passes_gradcheck_in_f64(mode):
    """The plain versions compute in f64 for f64 inputs, so the Function's
    CPU route can be checked against finite differences."""
    causal, window, prefix = mode
    q, k, v, _ = _inputs((1, 11, 11, 4, 2, 8), torch.float64, seed=11)
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.FlashAttentionFn.apply(q, k, v, causal, window,
                                                   prefix), args)


def test_function_only_under_grad_and_counts_nothing_on_cpu():
    q, k, v, do = _inputs((1, 40, 40, 4, 2, 16), torch.float32)
    before = (ops.launches(), ops.bwd_launches())
    plain = ops.flash_attention(q, k, v, window=7)
    assert plain.grad_fn is None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        assert ops.flash_attention(*leaves, window=7).grad_fn is None
    out = ops.flash_attention(*leaves, window=7)
    assert torch.equal(out.detach(), plain)
    out.backward(do)
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)
    assert (ops.launches(), ops.bwd_launches()) == before


def test_plain_lse_is_each_rows_log_sum_exp():
    q, k, v, _ = _inputs((2, 50, 50, 4, 2, 16), torch.float32)
    _, lse = flash_attention_torch(q, k, v, causal=True, window=12,
                                   prefix_len=5, return_lse=True, bk=16)
    qp = torch.arange(50)[:, None]
    kp = torch.arange(50)[None, :]
    keep = ((qp >= kp) | (kp < 5)) & (qp - kp < 12)
    s = torch.einsum("bqhd,bkhd->bhqk", q / 4.0, k.repeat_interleave(2, 2))
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the bf16 tensor-core form's roundings, emulated on the CPU
# ---------------------------------------------------------------------------

#: one batch row and one KV group of h2o-danube-1.8b's training attention:
#: (B, Sq, Skv, H, KV, D), causal
EMULATION_SHAPE = (1, 2048, 2048, 4, 1, 80)
LOG2E = 1.4426950408889634


def _excess(got, want, dtype):
    """How far ``got`` lies outside ``KERNEL_TOL[dtype]`` around ``want``
    (<= 0: within it everywhere)."""
    atol, rtol = KERNEL_TOL[dtype]
    want = want.float()
    return float(((got.float() - want).abs()
                  - (atol + rtol * want.abs())).max())


def _rounded(x, split: bool):
    """An f32 operand as the bf16 form feeds it to the tensor cores: bf16
    hi + lo (16 bits kept) when split, else rounded once to bf16."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if split else hi


def _emulate_bf16_form(q, k, v, o, do, lse, *, causal=True, window=0,
                       prefix_len=0, split_p=True, split_ds=True,
                       no_delta=False):
    """The arithmetic of ``csrc/flash_attention_bwd_wgmma.cu`` in torch:
    scores as f32 products of the bf16 inputs times scale * log2(e), P =
    exp2(s - lse log2(e)) under the mask, Drow = rowsum(dO o O) and dS = P
    (dP - Drow) in f32; P (into dV) and dS (into dK and dQ) rounded as the
    kernel feeds them to the tensor cores (``_rounded``); f32 sums, the
    scale applied to dQ and dK once at the end, each gradient rounded once
    to bf16.  ``no_delta`` plants a fault: dS taken without Drow."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(D)
    keep = _keep(torch.arange(Sq)[:, None], torch.arange(Skv)[None, :], Skv,
                 causal, window, prefix_len)
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(k.shape)
    for b in range(B):
        for h in range(H):
            kvh = h // G
            qh, gh = q[b, :, h].float(), do[b, :, h].float()
            kh, vh = k[b, :, kvh].float(), v[b, :, kvh].float()
            drow = 0.0 if no_delta else (gh * o[b, :, h].float()).sum(
                -1, keepdim=True)
            s = (qh @ kh.T) * (scale * LOG2E)
            p = torch.exp2(s - lse[b, h, :, None] * LOG2E).masked_fill(
                ~keep, 0.0)
            ds = _rounded(p * (gh @ vh.T - drow), split_ds)
            dv[b, :, kvh] += _rounded(p, split_p).T @ gh
            dk[b, :, kvh] += ds.T @ qh
            dq[b, :, h] = (ds @ kh) * scale
    return tuple(t.to(torch.bfloat16) for t in (dq, dk * scale, dv))


@pytest.fixture(scope="module")
def emulation_case():
    """danube's group in bf16: inputs, the plain forward's o and lse, and
    the plain backward (what the kernel is held to on the card)."""
    B, Sq, Skv, H, KV, D = EMULATION_SHAPE
    q, k, v, do = _inputs(EMULATION_SHAPE, torch.bfloat16, seed=0)
    o, lse = flash_attention_torch(q, k, v, causal=True, return_lse=True)
    want = flash_attention_bwd_torch(q, k, v, o, do, lse, causal=True)
    return (q, k, v, o, do, lse), want


def test_bf16_form_emulated_within_kernel_bound(emulation_case):
    """With P and dS split into bf16 hi + lo, the form's roundings keep
    dQ, dK and dV within the card's bound (2e-3 + 1e-2 |want|) of the
    plain version; dS taken without Drow, a planted fault, fails it."""
    args, want = emulation_case
    got = _emulate_bf16_form(*args)
    for name, g, w in zip("qkv", got, want):
        assert _excess(g, w, torch.bfloat16) <= 0, f"d{name}"
    fault = _emulate_bf16_form(*args, no_delta=True)
    assert max(_excess(g, w, torch.bfloat16)
               for g, w in zip(fault, want)) > 0


@pytest.mark.parametrize("operand", ["p", "ds"])
def test_bf16_form_needs_each_split(emulation_case, operand):
    """Why the kernel splits both operands: P rounded once to bf16 puts dV,
    and dS rounded once puts dK and dQ, outside the card's bound."""
    args, want = emulation_case
    got = _emulate_bf16_form(*args, split_p=operand != "p",
                             split_ds=operand != "ds")
    rounded = {"p": "v", "ds": "qk"}[operand]
    for name, g, w in zip("qkv", got, want):
        over = _excess(g, w, torch.bfloat16)
        assert (over > 0) == (name in rounded), (f"d{name}", over)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: (B, S, H, KV, D, causal, window, prefix_len)
CARD_CASES = [
    (2, 512, 32, 8, 80, True, 4096, 0),     # danube-1.8b's heads
    (1, 300, 8, 1, 256, True, 0, 100),      # MQA, D = 256, prefix in a tile
    (1, 257, 4, 2, 128, True, 96, 0),       # window across tiles, ragged
    (2, 200, 4, 4, 64, False, 0, 0),        # full
    (1, 130, 4, 2, 20, True, 0, 33),        # bf16 pads D to 24 forward
    (1, 70, 4, 1, 128, True, 0, 70),        # a prefix of every key
    (1, 190, 4, 2, 112, True, 0, 0),        # bf16: one 112-column piece
    (1, 160, 4, 1, 96, False, 0, 0),        # bf16: one 96-column piece
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_kernel_matches_plain_version(card, case, dtype):
    B, S, H, KV, D, causal, window, prefix = case
    q, k, v, do = _inputs((B, S, S, H, KV, D), dtype, device=card)
    mask = {"causal": causal, "window": window, "prefix_len": prefix}
    o, lse = ops._forward(q, k, v, causal, window, prefix, True)
    before = ops.bwd_launches()
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    want = flash_attention_bwd_torch(q, k, v, o, do, lse, **mask)
    torch.cuda.synchronize()
    assert ops.bwd_launches() == before + 1
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _excess(g, w, dtype) <= 0, f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_function_on_card_matches_plain_autograd(card, dtype):
    """Through ``flash_attention`` under grad: the forward keeps its lse,
    the backward launches the kernel; against autograd of the plain
    version.  D = 20 is padded to 24 in the bf16 forward only."""
    q, k, v, do = _inputs((2, 150, 150, 4, 2, 20), dtype, device=card)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (ops.launches(), ops.bwd_launches())
    got = torch.autograd.grad(ops.flash_attention(*leaves, prefix_len=17),
                              leaves, do)
    want = torch.autograd.grad(flash_attention_torch(*plain, prefix_len=17),
                               plain, do)
    torch.cuda.synchronize()
    assert (ops.launches(), ops.bwd_launches()) == (before[0] + 1,
                                                    before[1] + 1)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        assert _excess(g, w, dtype) <= 0, f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_backward_is_bit_identical_across_calls(card, dtype):
    """GQA is reduced in registers, with no atomics: two calls on the same
    inputs (danube-1.8b's heads) give the same bits."""
    q, k, v, do = _inputs((2, 512, 512, 32, 8, 80), dtype, device=card)
    o, lse = ops._forward(q, k, v, True, 0, 0, True)
    first = ops.flash_attention_bwd(q, k, v, o, do, lse)
    second = ops.flash_attention_bwd(q, k, v, o, do, lse)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a.view(bits), b.view(bits)), f"d{name}"


@pytest.mark.cuda
def test_lm_loss_backward_on_card_gives_attention_its_gradient(card,
                                                               monkeypatch):
    """A dense smoke model (qk-norm) in f32 on the card: every attention
    weight gets a non-zero gradient through the backward kernel, equal to
    the plain path's (attention by ``flash_attention_torch``)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import layers
    from repro_torch.models.common import init_params
    from repro_torch.models.lm import lm_loss
    cfg = smoke_config("qwen3-8b").scaled(dtype=torch.float32)
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg,
                         card)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 65)).astype(np.int32)).to(card)}

    def grads():
        leaves = [lp["attn"] for lp in params["layers"]]
        for attn in leaves:
            for t in attn.values():
                t.grad = None
                t.requires_grad_(True)
        loss, _ = lm_loss(params, cfg, batch)
        loss.backward()
        return [{n: t.grad.clone() for n, t in a.items()} for a in leaves]

    ops.reset_launches()
    kernel = grads()
    assert ops.bwd_launches() == cfg.n_layers
    monkeypatch.setattr(layers, "flash_attention", flash_attention_torch)
    plain = grads()
    for i, (gk, gp) in enumerate(zip(kernel, plain)):
        assert set(gk) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
        for name in gk:
            assert float(gk[name].abs().max()) > 0, (i, name)
            rel = float((gk[name] - gp[name]).norm() / gp[name].norm())
            assert rel <= 2e-3, (i, name, rel)
