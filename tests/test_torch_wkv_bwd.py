"""The gradient of the port's RWKV-6 WKV against the JAX package's.

The reference has no backward kernel: its gradient of the WKV is XLA's
autodiff of ``models/rwkv6.py::wkv6_chunked``.  On the CPU, on the same
numpy inputs: ``wkv6_bwd_torch`` (the backward kernel's plain version: the
chunks' entry states recomputed forward, then dS carried in reverse) and
the CPU route of ``WKV6Fn`` (what ``wkv6`` runs when an input requires
grad) against ``jax.vjp`` of ``wkv6_chunked``, for r, k, v, log_w and u,
over a ragged final chunk, K below 64, r, k and v as strided views of one
projection (as the model hands them over), mixed decays and the model's
slow ones, under which dS carries across chunks, and every log_w at the
model's clamp of -8 over chunks of 32 and 64, where factoring the
intra-chunk exponent would overflow f32; f32 at 2e-3 and bf16 at 5e-2 (atol
and rtol, the tolerances of ``tests/test_torch_train.py``).  The terms a
faulty backward could lose (the carried dS at the middle chunk, the decay
term of dcum_L, du) are shown to move the gradient past those tolerances.
The bf16 form's arithmetic (``csrc/wkv6_bwd_wgmma.cu``: chunks of 64, the
sub-chunk factorisation of the sums over E, the per-(t, i, d) diagonal
where a sub-chunk's cum falls too far, f32 operands split into bf16 parts),
emulated in f32 at rwkv6-1.6b's head width, stays within the card's bound
on slow, mixed and clamped decays; it leaves it with the E sums' operands in
two parts instead of three, or with the states stored as bf16 hi + lo
instead of f32 (why the kernel does neither), and the planted ``subblock``
fault (one off-diagonal sub-block's pairs left out) leaves it too.
On a card (``cuda`` marker, skipped without one): the backward kernel
against its plain version (per element 2e-3 + 2e-3 |want| in f32,
2e-3 + 1e-2 |want| in bf16, the bound ``chip_smoke.py`` holds), ``wkv6``
under grad launching the forward and the backward kernel, and two calls
giving the same bits.  The card tests import nothing of JAX:

    python -m pytest -q -m cuda tests/test_torch_wkv_bwd.py
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_torch, wkv6_torch

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
KERNEL_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]
NAMES = ("r", "k", "v", "log_w", "u")
LOG_W_MIN = -8.0
#: (B, S, H, K, decay, strided): a ragged final chunk, K below 64, one
#: chunk and less, and r, k, v as views of one projection
CASES = [
    (2, 75, 2, 16, "mixed", False),
    (1, 100, 3, 8, "slow", True),
    (2, 64, 2, 12, "clamp", True),
    (1, 20, 2, 16, "mixed", False),
]


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
    return "B{}-S{}-H{}-K{}-{}-{}".format(
        *case[:5], "strided" if case[5] else "contiguous")


def _inputs(B, S, H, K, decay, strided, dtype=torch.float32, seed=0,
            device="cpu"):
    """r, k, v, log_w, u as the model hands them over (r, k, v and u in
    ``dtype``, log_w in f32 and clamped at -8) and do.  "slow": log_w =
    -exp(-5 + 0.5 normal), the model's range at its initialisation, under
    which the state carries across chunks; "mixed": the odd channels
    -exp(normal) instead, under which they die within a chunk; "clamp":
    every log_w at -8.  ``strided``: r, k, v are views of one (B, S, H,
    3K + 2) tensor."""
    rng = np.random.default_rng(seed)
    rkv = rng.standard_normal((B, S, H, 3 * K + 2), np.float32)
    log_w = -np.exp(-5.0 + 0.5 * rng.standard_normal((B, S, H, K)))
    if decay == "mixed":
        log_w[..., 1::2] = -np.exp(rng.standard_normal((B, S, H, K)))[..., 1::2]
    if decay == "clamp":
        log_w[:] = LOG_W_MIN
    log_w = np.maximum(log_w, LOG_W_MIN)
    u = 0.5 * rng.standard_normal((H, K))
    do = rng.standard_normal((B, S, H, K), np.float32)

    def t(a, dt_=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device,
                                                              dtype=dt_)
    whole = t(rkv)
    if strided:
        r, k, v = (whole[..., 2 + i * K:2 + (i + 1) * K] for i in range(3))
    else:
        r, k, v = (whole[..., i * K:(i + 1) * K].contiguous()
                   for i in range(3))
    return [r, k, v, t(log_w, torch.float32), t(u)], t(do)


@pytest.fixture(scope="module")
def reference_vjp():
    """The five gradients of the reference's ``wkv6_chunked`` (over chunks
    of ``chunk``) by ``jax.vjp``, as f32 numpy."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.rwkv6 import wkv6_chunked

    def to_jax(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    def run(args, do, chunk=32):
        _, vjp = jax.vjp(lambda *a: wkv6_chunked(*a, chunk=chunk),
                         *map(to_jax, args))
        return [np.asarray(g, np.float32) for g in vjp(to_jax(do))]
    return run


def _close(got, want, dtype, what):
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), f"{what} d{name}"
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=f"{what} d{name}")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gradient_matches_reference_autodiff(reference_vjp, case, dtype):
    """Both routes on one reference run: the plain backward and the
    Function's, each gradient in its input's dtype and shape."""
    args, do = _inputs(*case, dtype=dtype)
    want = reference_vjp(args, do)
    plain = wkv6_bwd_torch(*args, do, chunk=ops.CHUNK)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    o = ops.wkv6(*leaves)
    assert type(o.grad_fn).__name__ == "WKV6FnBackward"
    function = torch.autograd.grad(o, leaves, do)
    for got in (plain, function):
        for g, a in zip(got, args):
            assert g.dtype == a.dtype and g.shape == a.shape
    _close(plain, want, dtype, "plain")
    _close(function, want, dtype, "function")


@pytest.mark.parametrize("chunk", [32, 64])
def test_clamped_decay_over_long_chunks(reference_vjp, chunk):
    """Every log_w at -8: a chunk's cum reaches -8 L, so every term is
    evaluated per (t, i, d) below the diagonal; over chunks of 32 and 64
    (the reference's over the same chunks), finite and within 2e-3."""
    args, do = _inputs(2, 150, 2, 16, "clamp", False)
    _close(wkv6_bwd_torch(*args, do, chunk=chunk),
           reference_vjp(args, do, chunk=chunk), torch.float32,
           f"chunk {chunk}")


def test_plain_backward_matches_autograd_of_plain_forward():
    """Against autograd of ``wkv6_torch``, the plain path ``chip_smoke.py``
    holds the kernel path to."""
    args, do = _inputs(2, 90, 3, 8, "mixed", True)
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(wkv6_torch(*leaves, chunk=ops.CHUNK), leaves,
                               do)
    got = wkv6_bwd_torch(*args, do, chunk=ops.CHUNK)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                   msg=f"d{name}")


@pytest.mark.parametrize("fault", ["carry", "decay_term", "du"])
def test_each_term_matters_on_slow_decays(fault):
    """Leaving out a term the backward needs moves the gradient past the
    f32 tolerance, so the tests above would catch a backward without it."""
    args, do = _inputs(2, 128, 2, 16, "slow", False)
    want = wkv6_bwd_torch(*args, do)
    if fault == "du":
        bad = list(want)
        bad[4] = torch.zeros_like(bad[4])
    else:
        bad = wkv6_bwd_torch(*args, do, omit=(fault,))
    over = max(float(((g - w).abs() - 2e-3 * (1 + w.abs())).max())
               for g, w in zip(bad, want))
    assert over > 0, fault


#: the bf16 form's chunk, sub-chunk and the fall of cum (log2 units) past
#: which its diagonal sub-blocks are formed per (t, i, d) (``kRange``)
FORM_CHUNK, SUB, K_RANGE = 64, 16, 100.0
#: bf16 parts of each f32 operand of the form's products: the walks' (kdec
#: and r exp(cum_ex)), the E sums' (dA, R^ = r exp(cum_ex - c_{p-1}), K~ = k
#: exp(c_j - cum)), the rest (A^T's K~ weighted per row sub-chunk, A, kdec);
#: the states S_c and G_c are stored in f32 (None) and split into three
#: parts where they enter a product
FORM_PARTS = {"walk": 3, "esum": 3, "rest": 2, "state": None}


def _rounded(t, parts):
    """``t`` as a product's operand in the bf16 form: the sum of its first
    ``parts`` bf16 parts (hi, then what hi leaves, ...); None keeps f32."""
    if parts is None:
        return t
    out = torch.zeros_like(t)
    for _ in range(parts):
        out = out + (t - out).to(torch.bfloat16).float()
    return out


def _emulate_bf16_form(r, k, v, log_w, u, do, **parts):
    """The bf16 form's arithmetic (``wkv6_bwd_wgmma.cu``) in f32 on the CPU,
    vectorised over (batch, chunk, head): two state walks whose carry stays
    f32 (S_c forward, G_c, the gradient of the state leaving chunk c, in
    reverse), then each chunk of 64 on its own.  The sums over E use the
    sub-chunk factorisation: with c_j the cum at the end of sub-chunk j
    (c_{-1} = 0), Ks = exp(c_j - cum_i) and Rs = exp(cum_ex_t - c_{p-1})
    (both <= 1), and Gv[p][j] = exp(c_{p-1} - c_j),
        dr_t = sum_j Rs_t Gv[p][j] (dA[:, j] K~_j)_t,   K~ = k Ks,
        dk_i = sum_p Ks_i Gv[p][j] (dA[p, :]^T R^_p)_i, R^ = r Rs,
        A^T[i][t in p] = (k Ks Gv[p][j]) . R^_t,
    over j < p, and the diagonal j = p too unless a sub-chunk's cum falls
    more than ``K_RANGE`` in some channel of the chunk; then the diagonal
    sub-blocks are evaluated per (t, i, d), exactly.  Each f32 operand is
    rounded as the kernel feeds it (``FORM_PARTS``, overridden by
    ``parts``)."""
    parts = {**FORM_PARTS, **parts}
    L = FORM_CHUNK
    B, S, H, K = r.shape
    n = -(-S // L)

    def chunks(x):
        return F.pad(x.float(), (0, 0, 0, 0, 0, n * L - S)).reshape(
            B, n, L, H, K).permute(0, 1, 3, 2, 4)       # (B, n, H, L, K)
    rc, kc, vc, lwc, doc = map(chunks, (r, k, v, log_w, do))
    uf = u.float()[None, None, :, None, :]
    cum = torch.cumsum(lwc, 3)
    cx = cum - lwc
    cl = cum[..., -1, :]
    sub = torch.arange(L) // SUB
    cref = cum[..., SUB - 1::SUB, :]                     # c_0 .. c_3
    cprev = torch.cat([torch.zeros_like(cref[..., :1, :]),
                       cref[..., :-1, :]], -2)           # c_{p-1}
    Ks = torch.exp(cref[..., sub, :] - cum)
    Rs = torch.exp(cx - cprev[..., sub, :])
    dec = Ks * torch.exp(cl[..., None, :] - cref)[..., sub, :]
    kdec = kc * dec                             # k exp(cum_L - cum_i)
    ecx = Rs * torch.exp(cprev[..., sub, :])
    Gv = torch.exp(cprev[..., :, None, :] - cref[..., None, :, :])
    slow = ((cprev - cref) * math.log2(math.e) > K_RANGE).flatten(-2).any(-1)
    fast = ~slow[..., None, None]

    def walk(order, operand, other):
        out, st = [None] * n, torch.zeros((B, H, K, K))
        for c in order:
            out[c] = _rounded(st, parts["state"])
            st = st * torch.exp(cl[:, c])[..., None] + torch.einsum(
                "bhtd,bhtc->bhdc", _rounded(operand[:, c], parts["walk"]),
                other[:, c])
        return torch.stack(out, 1)                       # (B, n, H, d, c)
    Sc = walk(range(n), kdec, vc)
    Gc = walk(reversed(range(n)), rc * ecx, doc)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool), -1)
    same = sub[:, None] == sub[None, :]
    E = torch.exp(torch.where((tri & same)[..., None], cx[..., :, None, :]
                              - cum[..., None, :, :], -math.inf))
    Rt = _rounded(rc * Rs, parts["esum"])
    Kt = _rounded(kc * Ks, parts["esum"])

    def valid(later, p):                    # sub-chunks after p, or p where fast
        return later[None, None, None, :, None] | (
            (sub == p)[None, None, None, :, None] & fast)
    A = torch.zeros(B, n, H, L, L)
    for p in range(4):
        kp = torch.where(valid(sub < p, p),
                         kc * Ks * Gv[..., p, :, :][..., sub, :], 0.0)
        A[..., SUB * p:SUB * (p + 1), :] = torch.einsum(
            "bnhid,bnhtd->bnhti", _rounded(kp, parts["rest"]),
            _rounded(rc * Rs, 2)[..., SUB * p:SUB * (p + 1), :])
    A = torch.where(slow[..., None, None] & same, torch.einsum(
        "bnhtd,bnhid,bnhtid->bnhti", rc, kc, E), torch.where(tri, A, 0.0))
    A = A + torch.diag_embed((rc * uf * kc).sum(-1))
    dv = torch.einsum("bnhti,bnhtc->bnhic", _rounded(A, parts["rest"]), doc) \
        + torch.einsum("bnhid,bnhdc->bnhic", _rounded(kdec, parts["rest"]),
                       Gc)
    dA = torch.where(tri, torch.einsum("bnhtc,bnhic->bnhti", doc, vc), 0.0)
    dAr = _rounded(dA, parts["esum"])
    o_state = torch.einsum("bnhtc,bnhdc->bnhtd", doc, Sc) * ecx
    dr_e = torch.zeros_like(rc)
    dk_e = torch.zeros_like(kc)
    for j in range(4):
        cols = slice(SUB * j, SUB * (j + 1))
        dr_e = dr_e + torch.where(
            valid(sub > j, j), Rs * Gv[..., :, j, :][..., sub, :]
            * torch.einsum("bnhti,bnhid->bnhtd", dAr[..., cols],
                           Kt[..., cols, :]), 0.0)
        dk_e = dk_e + torch.where(
            valid(sub < j, j), Ks * Gv[..., j, :, :][..., sub, :]
            * torch.einsum("bnhti,bnhtd->bnhid", dAr[..., cols, :],
                           Rt[..., cols, :]), 0.0)
    diag = torch.where(slow[..., None, None], dA * same, 0.0)
    dr_e = dr_e + torch.einsum("bnhti,bnhid,bnhtid->bnhtd", diag, kc, E)
    dk_e = dk_e + torch.einsum("bnhti,bnhtd,bnhtid->bnhid", diag, rc, E)
    dbeta = (doc * vc).sum(-1)[..., None]
    dkdec = torch.einsum("bnhic,bnhdc->bnhid", vc, Gc)
    kk = kdec * dkdec
    dcx = rc * (o_state + dr_e)
    dcum = -kc * dk_e
    dcum[..., :-1, :] -= kk[..., :-1, :]
    dcum[..., -1, :] += kk[..., :-1, :].sum(-2) + torch.exp(cl) * (
        Sc * Gc).sum(-1)
    dlw = torch.flip(torch.cumsum(torch.flip(dcum + dcx, [3]), 3), [3]) - dcx

    def un(x):
        return x.permute(0, 1, 3, 2, 4).reshape(B, n * L, H, K)[:, :S]
    return (un(o_state + dr_e + dbeta * uf * kc).to(r.dtype),
            un(dk_e + dbeta * uf * rc + dec * dkdec).to(k.dtype),
            un(dv).to(v.dtype), un(dlw).to(log_w.dtype),
            (dbeta * rc * kc).sum((0, 1, 3)).to(u.dtype))


#: (B, S, H, K): rwkv6-1.6b's head width over eight chunks of the form
EMULATION_SHAPE = (1, 512, 8, 64)


@pytest.fixture(scope="module")
def emulation_cases():
    """Inputs, do and the plain backward (what the kernel is held to on the
    card), in bf16, by decay."""
    cache = {}

    def get(decay, H=EMULATION_SHAPE[2]):
        if (decay, H) not in cache:
            B, S, _, K = EMULATION_SHAPE
            args, do = _inputs(B, S, H, K, decay, True, dtype=torch.bfloat16)
            cache[decay, H] = args, do, wkv6_bwd_torch(*args, do,
                                                       chunk=ops.CHUNK)
        return cache[decay, H]
    return get


@pytest.mark.parametrize("decay", ["slow", "mixed", "clamp"])
def test_bf16_form_emulated_within_kernel_bound(emulation_cases, decay):
    """With its operands split as the kernel splits them, the form's
    roundings keep every gradient within the card's bf16 bound (2e-3 +
    1e-2 |want|) of the plain version: on slow decays (the state carries
    over the whole sequence), mixed ones and every log_w at the clamp,
    where every chunk takes the per-(t, i, d) diagonal."""
    args, do, want = emulation_cases(decay)
    for name, g, w in zip(NAMES, _emulate_bf16_form(*args, do), want):
        assert _excess(g, w, torch.bfloat16) <= 0, f"d{name}"


@pytest.mark.parametrize("operand", ["esum", "state"])
def test_bf16_form_needs_its_precision(emulation_cases, operand):
    """Why the E sums' operands take three bf16 parts and the states stay
    f32: dlog_w is a difference of dcum and dcum_ex (and of the state's
    sum_c S_c G_c), whose terms cancel, so with the E sums' operands in two
    parts, or S_c and G_c stored as bf16 hi + lo, dlog_w leaves the bound
    on slow decays over 16 heads."""
    args, do, want = emulation_cases("slow", H=16)
    got = _emulate_bf16_form(*args, do, **{operand: 2})
    assert _excess(got[3], want[3], torch.bfloat16) > 0


def test_subblock_fault_leaves_the_bound(emulation_cases):
    """``omit=("subblock",)`` (one off-diagonal sub-block's pairs left out
    of dr's and dk's sums over E, the planted fault of the card's check)
    puts dr and dk far past the bf16 bound on slow decays."""
    args, do, want = emulation_cases("slow")
    bad = wkv6_bwd_torch(*args, do, chunk=ops.CHUNK, omit=("subblock",))
    for i in (0, 1):
        assert _excess(bad[i], want[i], torch.bfloat16) > 1.0, NAMES[i]


def test_function_only_under_grad_and_counts_nothing_on_cpu():
    args, do = _inputs(1, 50, 2, 8, "mixed", True)
    before = (ops.launches(), ops.bwd_launches())
    plain = ops.wkv6(*args)
    assert plain.grad_fn is None
    leaves = [a.clone().requires_grad_(True) for a in args]
    with torch.no_grad():
        assert ops.wkv6(*leaves).grad_fn is None
    o = ops.wkv6(*leaves)
    assert torch.equal(o.detach(), plain)
    o.backward(do)
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)
    assert (ops.launches(), ops.bwd_launches()) == before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _excess(got, want, dtype):
    atol, rtol = KERNEL_TOL[dtype]
    want = want.float()
    return float(((got.float() - want).abs()
                  - (atol + rtol * want.abs())).max())


#: (B, S, H, K, decay, strided): rwkv6-1.6b's heads at a ragged length and
#: at the clamp, one chunk and less, and the CPU cases
CARD_CASES = [(2, 300, 32, 64, "mixed", True),
              (1, 256, 8, 64, "clamp", False),
              (3, 31, 5, 64, "slow", True)] + CASES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids)
def test_kernel_matches_plain_version(card, case, dtype):
    args, do = _inputs(*case, dtype=dtype, device=card)
    before = ops.bwd_launches()
    got = ops.wkv6_bwd(*args, do)
    want = wkv6_bwd_torch(*args, do, chunk=ops.CHUNK)
    torch.cuda.synchronize()
    assert ops.bwd_launches() == before + 1
    for name, g, w, a in zip(NAMES, got, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert bool(torch.isfinite(g).all()), f"d{name}"
        assert _excess(g, w, dtype) <= 0, f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_function_on_card_matches_plain_autograd(card, dtype):
    """Through ``wkv6`` under grad: the forward kernel, then the backward
    kernel; against autograd of the plain version."""
    args, do = _inputs(2, 200, 4, 64, "slow", True, dtype=dtype, device=card)
    leaves = [a.clone().requires_grad_(True) for a in args]
    plain = [a.clone().requires_grad_(True) for a in args]
    before = (ops.launches(), ops.bwd_launches())
    got = torch.autograd.grad(ops.wkv6(*leaves), leaves, do)
    want = torch.autograd.grad(wkv6_torch(*plain, chunk=ops.CHUNK), plain,
                               do)
    torch.cuda.synchronize()
    assert (ops.launches(), ops.bwd_launches()) == (before[0] + 1,
                                                    before[1] + 1)
    for name, g, w in zip(NAMES, got, want):
        assert _excess(g, w, dtype) <= 0, f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_backward_is_bit_identical_across_calls(card, dtype):
    """du's sum over the batch is per-block partials summed in order, with
    no atomics: two calls on the same inputs give the same bits."""
    args, do = _inputs(2, 512, 32, 64, "mixed", True, dtype=dtype,
                       device=card)
    first = ops.wkv6_bwd(*args, do)
    second = ops.wkv6_bwd(*args, do)
    for name, a, b in zip(NAMES, first, second):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits)), f"d{name}"
