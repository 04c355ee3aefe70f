"""The gradient of the port's Mamba-2 SSD against the JAX package's.

The reference has no backward kernel: its gradient of the SSD is XLA's
autodiff of ``models/mamba2.py::ssd_chunked``.  On the CPU, on the same
numpy inputs: ``ssd_bwd_torch`` (the backward kernel's plain version: the
chunks' entry states recomputed forward, then dS carried in reverse) and
the CPU route of ``SSDFn`` (what ``ssd`` runs when an input requires grad)
against ``jax.vjp`` of ``ssd_chunked``, for all six inputs, over a ragged
final chunk, P and N below 64, B and C as strided views of one tensor (as
the model hands them over), a nonzero D, and both the random-weight model's
fast decay and Mamba-2's initial slow decay, under which dS carries across
chunks; f32 at 2e-3 and bf16 at 5e-2 (atol and rtol, the tolerances of
``tests/test_torch_train.py``).  The terms a faulty backward could lose
(the carried dS at the middle chunk, the decay term of dcum_L, dD, one
head's dcb in the sum over the heads that dB and dC take) are shown to move
the gradient past those tolerances.  The bf16 form's arithmetic, emulated
in f32 at zamba2's head width, stays within the card's bound with its six
f32 operands split into bf16 parts, and leaves it with any one of them
rounded to bf16 alone, or with the walks' operands in two parts instead
of three (why the kernel splits as it does).  On a card (``cuda``
marker, skipped without one): the backward kernel against its plain version
(per element 2e-3 + 2e-3 |want| in f32, 2e-3 + 1e-2 |want| in bf16, the
bound ``chip_smoke.py`` holds), ``ssd`` under grad launching the forward
and the backward kernel, and two calls giving the same bits.  The card
tests import nothing of JAX:

    python -m pytest -q -m cuda tests/test_torch_ssd_bwd.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2_ssd import ops
from repro_torch.kernels.mamba2_ssd.ref import ssd_bwd_torch, ssd_torch

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
KERNEL_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]
NAMES = ("x", "dt", "A_log", "B", "C", "D")
#: (B, S, H, P, N, decay, strided): a ragged final chunk, P and N below 64
#: and unequal, one chunk exactly, and B and C as views of one tensor
CASES = [
    (2, 150, 3, 16, 8, "slow", False),
    (1, 200, 2, 8, 12, "model", True),
    (2, 64, 2, 32, 16, "slow", True),
    (1, 130, 4, 16, 16, "model", False),
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
    return "B{}-S{}-H{}-P{}-N{}-{}-{}".format(
        *case[:6], "strided" if case[6] else "contiguous")


def _inputs(B, S, H, P, N, decay, strided, dtype=torch.float32, seed=0,
            device="cpu"):
    """x, dt, A_log, B, C, D as the model hands them over (x, B, C and D in
    ``dtype``, dt and A_log in f32) and dy.  "slow": Mamba-2's initial
    ranges (A in [1, 16], one draw in each of H strata; dt log-uniform in
    [1e-3, 1e-1]), under which a head's state carries across chunks;
    "model": dt = softplus(normal), A_log = normal / 2, under which it dies
    within a chunk.  ``strided``: B and C are views of one (B, S, 2N + 5)
    tensor, as ``torch.split`` of the conv output gives them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    bc = rng.standard_normal((B, S, 2 * N + 5), np.float32)
    if decay == "model":
        dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)))
        A_log = rng.standard_normal(H) * 0.5
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H)))
        A_log = np.log(1.0 + 15.0 * (np.arange(H) + rng.random(H)) / H)
    D = rng.standard_normal(H)
    dy = rng.standard_normal((B, S, H, P), np.float32)

    def t(a, dt_=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device,
                                                              dtype=dt_)
    bc_t = t(bc)
    if strided:
        Bm, Cm = bc_t[..., 5:5 + N], bc_t[..., 5 + N:5 + 2 * N]
    else:
        Bm, Cm = bc_t[..., :N].contiguous(), bc_t[..., N:2 * N].contiguous()
    args = [t(x), t(dt, torch.float32), t(A_log, torch.float32), Bm, Cm, t(D)]
    return args, t(dy)


@pytest.fixture(scope="module")
def reference_vjp():
    """The six gradients of the reference's ``ssd_chunked`` by
    ``jax.vjp``, as f32 numpy."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.mamba2 import ssd_chunked

    def to_jax(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    def run(args, dy):
        _, vjp = jax.vjp(ssd_chunked, *map(to_jax, args))
        return [np.asarray(g, np.float32) for g in vjp(to_jax(dy))]
    return run


def _close(got, want, dtype, what):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=f"{what} d{name}")


def _excess(got, want, dtype):
    """The largest amount by which ``got`` lies outside the card's bound
    around ``want`` (<= 0: within it everywhere)."""
    atol, rtol = KERNEL_TOL[dtype]
    want = want.float()
    return float(((got.float() - want).abs()
                  - (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gradient_matches_reference_autodiff(reference_vjp, case, dtype):
    """Both routes on one reference run: the plain backward and the
    Function's, each gradient in its input's dtype and shape."""
    args, dy = _inputs(*case, dtype=dtype)
    want = reference_vjp(args, dy)
    plain = ssd_bwd_torch(*args, dy, chunk=ops.CHUNK)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y = ops.ssd(*leaves)
    assert type(y.grad_fn).__name__ == "SSDFnBackward"
    function = torch.autograd.grad(y, leaves, dy)
    for got in (plain, function):
        for g, a in zip(got, args):
            assert g.dtype == a.dtype and g.shape == a.shape
    _close(plain, want, dtype, "plain")
    _close(function, want, dtype, "function")


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_backward_is_chunk_free(reference_vjp, chunk):
    """The gradient does not depend on the chunk length: the plain backward
    over shorter chunks against the reference's over 64."""
    args, dy = _inputs(*CASES[0])
    _close(ssd_bwd_torch(*args, dy, chunk=chunk), reference_vjp(args, dy),
           torch.float32, f"chunk {chunk}")


def test_plain_backward_matches_autograd_of_plain_forward():
    """Against autograd of ``ssd_torch``, the plain path ``chip_smoke.py``
    holds the kernel path to."""
    args, dy = _inputs(2, 100, 3, 8, 6, "slow", True)
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ssd_torch(*leaves, chunk=ops.CHUNK), leaves,
                               dy)
    got = ssd_bwd_torch(*args, dy, chunk=ops.CHUNK)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                   msg=f"d{name}")


@pytest.mark.parametrize("fault", ["carry", "decay_term", "dD", "head_dcb"])
def test_each_term_matters_on_slow_decays(fault):
    """Leaving out a term the backward needs moves the gradient past the
    f32 tolerance, so the tests above would catch a backward without it."""
    args, dy = _inputs(2, 256, 3, 16, 16, "slow", False)
    want = ssd_bwd_torch(*args, dy)
    if fault == "dD":
        bad = list(want)
        bad[5] = torch.zeros_like(bad[5])
    else:
        bad = ssd_bwd_torch(*args, dy, omit=(fault,))
    over = max(float(((g - w).abs() - 2e-3 * (1 + w.abs())).max())
               for g, w in zip(bad, want))
    assert over > 0, fault


#: the f32 operands the bf16 form feeds its products in bf16 parts: the
#: walks' (kdec x, exp(cum) dy) as hi + mid + lo, the rest as hi + lo
SPLITS = ("W", "dcb", "S", "G", "kdec_x", "ecum_dy")
WALKS = ("kdec_x", "ecum_dy")
#: zamba2's heads (P = N = 64) on Mamba-2's slow decays, at a CPU size
EMULATION_SHAPE = (1, 1024, 16, 64, 64, "slow", True)


def _rounded(t, parts):
    """``t`` as a product's operand in the bf16 form: the sum of its first
    ``parts`` bf16 parts (hi, then what hi leaves, ...)."""
    out = torch.zeros_like(t)
    for _ in range(parts):
        out = out + (t - out).to(torch.bfloat16).float()
    return out


def _emulate_bf16_form(x, dt, A_log, B, C, D, dy, drop=(), walk_parts=3):
    """The bf16 form's arithmetic (``mamba2_ssd_bwd_wgmma.cu``) in f32 on
    the CPU: ``ssd_bwd_torch``'s terms in the kernel's order (two state
    walks whose carry stays f32 and whose stored S_c and G_c are rounded,
    then each chunk on its own), each of the six f32 operands in
    ``SPLITS`` rounded as the kernel feeds it to its products (the walks'
    in ``walk_parts`` parts, the rest in two), hi alone where named in
    ``drop``."""
    parts = {s: 1 if s in drop else walk_parts if s in WALKS else 2
             for s in SPLITS}
    L = ops.CHUNK
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    n = -(-S // L)
    pad = n * L - S

    def chunks(t, *tail):
        return torch.nn.functional.pad(
            t.float(), (0, 0) * len(tail) + (0, pad)).reshape(Bsz, n, L,
                                                              *tail)
    xc, dyc = chunks(x, H, P), chunks(dy, H, P)
    dtc, Bc, Cc = chunks(dt, H), chunks(B, N), chunks(C, N)
    A = torch.exp(A_log.float())
    lac = -dtc * A
    cumc = torch.cumsum(lac, dim=2)
    ecum = torch.exp(cumc)
    dec = torch.exp(cumc[:, :, -1:] - cumc)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, :, :, None]
    strict = torch.tril(torch.ones((L, L), dtype=torch.bool), -1)[
        None, :, :, None]
    states, grads = [None] * n, [None] * n
    st = torch.zeros((Bsz, H, P, N))
    for c in range(n):
        states[c] = _rounded(st, parts["S"])
        kx = _rounded(xc[:, c] * (dec[:, c] * dtc[:, c])[..., None],
                      parts["kdec_x"])
        st = st * ecum[:, c, -1][..., None, None] + torch.einsum(
            "blhp,bln->bhpn", kx, Bc[:, c])
    st = torch.zeros_like(st)
    for c in reversed(range(n)):
        grads[c] = _rounded(st, parts["G"])
        ey = _rounded(dyc[:, c] * ecum[:, c][..., None], parts["ecum_dy"])
        st = st * ecum[:, c, -1][..., None, None] + torch.einsum(
            "blhp,bln->bhpn", ey, Cc[:, c])
    out = {k: [] for k in ("dx", "ddt", "dB", "dC")}
    dA_log = torch.zeros((H,))
    for c in range(n):
        xb, dyb, dtb, Bb, Cb = xc[:, c], dyc[:, c], dtc[:, c], Bc[:, c], \
            Cc[:, c]
        cum, s_in, g = cumc[:, c], states[c], grads[c]
        dC_state = torch.einsum("blhp,bhpn->blhn", dyb, s_in) \
            * ecum[:, c][..., None]
        dcum = (dC_state * Cb[:, :, None, :]).sum(-1)
        expo = cum[:, :, None, :] - cum[:, None, :, :]
        gg = torch.where(tri, torch.exp(torch.where(tri, expo, 0.0)), 0.0)
        cb = torch.einsum("bln,bin->bli", Cb, Bb)
        dW = torch.where(tri, torch.einsum("blhp,bihp->blih", dyb, xb), 0.0)
        w = _rounded(gg * cb[..., None] * dtb[:, None, :, :], parts["W"])
        m = dW * gg * cb[..., None]
        dcb = _rounded((dW * gg * dtb[:, None, :, :]).sum(-1), parts["dcb"])
        kdec = dec[:, c] * dtb
        xg = torch.einsum("bihp,bhpn->bihn", xb, g)
        dk = (xg * Bb[:, :, None, :]).sum(-1)
        q = torch.where(strict, m * dtb[:, None, :, :], 0.0)
        dcum = dcum + q.sum(2) - q.sum(1)
        kk = (dk * kdec)[:, :-1]
        dcum[:, :-1] -= kk
        dcum[:, -1] += kk.sum(1) + ecum[:, c, -1] * (g * s_in).sum((-1, -2))
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        out["dx"].append(torch.einsum("blih,blhp->bihp", w, dyb)
                         + kdec[..., None]
                         * torch.einsum("bin,bhpn->bihp", Bb, g))
        out["ddt"].append(m.sum(1) + dk * dec[:, c] - A * dla)
        out["dB"].append(torch.einsum("bli,bln->bin", dcb, Cb)
                         + (kdec[..., None] * xg).sum(2))
        out["dC"].append(dC_state.sum(2)
                         + torch.einsum("bli,bin->bln", dcb, Bb))
        dA_log = dA_log + (dla * lac[:, c]).sum((0, 1))

    def unchunk(parts, *tail):
        return torch.stack(parts, dim=1).reshape(Bsz, n * L, *tail)[:, :S]
    dx = unchunk(out["dx"], H, P) + D.float()[None, None, :, None] \
        * dy.float()
    dD = (dy.float() * x.float()).sum((0, 1, 3))
    return (dx.to(x.dtype), unchunk(out["ddt"], H).to(dt.dtype),
            dA_log.to(A_log.dtype), unchunk(out["dB"], N).to(B.dtype),
            unchunk(out["dC"], N).to(C.dtype), dD.to(D.dtype))


@pytest.fixture(scope="module")
def emulation_case():
    """zamba2's heads in bf16 at a CPU size: inputs, dy and the plain
    backward (what the kernel is held to on the card)."""
    args, dy = _inputs(*EMULATION_SHAPE, dtype=torch.bfloat16)
    return args, dy, ssd_bwd_torch(*args, dy, chunk=ops.CHUNK)


def test_bf16_form_emulated_within_kernel_bound(emulation_case):
    """With the six operands split into bf16 parts, the form's roundings
    keep every gradient within the card's bf16 bound (2e-3 + 1e-2 |want|)
    of the plain version."""
    args, dy, want = emulation_case
    got = _emulate_bf16_form(*args, dy)
    for name, g, w in zip(NAMES, got, want):
        assert _excess(g, w, torch.bfloat16) <= 0, f"d{name}"


def test_bf16_form_walks_need_three_parts():
    """Why the walks split their operand into hi + mid + lo: with hi + lo,
    the error left in the carried state gradient G_c reaches ddt through
    x G_c, and at 32 chunks of 16 heads one ddt element leaves the bound
    (the kernel's did on a card, as this emulation does)."""
    args, dy = _inputs(2, 2048, 16, 64, 64, "slow", True,
                       dtype=torch.bfloat16)
    want = ssd_bwd_torch(*args, dy, chunk=ops.CHUNK)
    two = _emulate_bf16_form(*args, dy, walk_parts=2)
    assert _excess(two[1], want[1], torch.bfloat16) > 0
    three = _emulate_bf16_form(*args, dy)
    for name, g, w in zip(NAMES, three, want):
        assert _excess(g, w, torch.bfloat16) <= 0, f"d{name}"


#: operand rounded to bf16 once -> the gradients it puts past the bound
SPLIT_NEEDED_BY = {"W": ("x",), "dcb": ("B", "C"), "S": ("dt", "C"),
                   "G": ("x", "dt", "B"), "kdec_x": ("dt", "C"),
                   "ecum_dy": ("x", "dt", "B")}


@pytest.mark.parametrize("operand", SPLITS)
def test_bf16_form_needs_each_split(emulation_case, operand):
    """Why the kernel splits all six operands: any one rounded once to bf16
    puts some gradient outside the card's bound (the states and the walks'
    operands, through ddt's cancellations, the most)."""
    args, dy, want = emulation_case
    got = _emulate_bf16_form(*args, dy, drop=(operand,))
    for name, g, w in zip(NAMES, got, want):
        over = _excess(g, w, torch.bfloat16)
        assert (over > 0) == (name in SPLIT_NEEDED_BY[operand]), (
            f"d{name}", over)


def test_function_only_under_grad_and_counts_nothing_on_cpu():
    args, dy = _inputs(1, 70, 2, 8, 8, "slow", True)
    before = (ops.launches(), ops.bwd_launches())
    plain = ops.ssd(*args)
    assert plain.grad_fn is None
    leaves = [a.clone().requires_grad_(True) for a in args]
    with torch.no_grad():
        assert ops.ssd(*leaves).grad_fn is None
    y = ops.ssd(*leaves)
    assert torch.equal(y.detach(), plain)
    y.backward(dy)
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


#: (B, S, H, P, N, decay, strided): zamba2's heads at a ragged length, 32
#: chunks of 16 heads (where the f32 emulation of the bf16 form puts one
#: ddt element past the bound), one chunk and less, and the CPU cases
CARD_CASES = [(2, 300, 80, 64, 64, "slow", True),
              (2, 2048, 16, 64, 64, "slow", True),
              (1, 64, 4, 64, 64, "model", False),
              (3, 37, 5, 32, 16, "slow", True)] + CASES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids)
def test_kernel_matches_plain_version(card, case, dtype):
    args, dy = _inputs(*case, dtype=dtype, device=card)
    before = ops.bwd_launches()
    got = ops.ssd_bwd(*args, dy)
    want = ssd_bwd_torch(*args, dy, chunk=ops.CHUNK)
    torch.cuda.synchronize()
    assert ops.bwd_launches() == before + 1
    for name, g, w, a in zip(NAMES, got, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert bool(torch.isfinite(g).all()), f"d{name}"
        assert _excess(g, w, dtype) <= 0, f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_function_on_card_matches_plain_autograd(card, dtype):
    """Through ``ssd`` under grad: the forward kernel, then the backward
    kernel; against autograd of the plain version on f32 copies.  (x enters
    the plain bf16 graph twice, through the scan and the skip, each behind
    its own cast: autograd rounds each branch's dx to bf16 and sums them in
    bf16, two roundings, which cancellation makes larger than the bound.)"""
    args, dy = _inputs(2, 200, 6, 64, 64, "slow", True, dtype=dtype,
                       device=card)
    leaves = [a.clone().requires_grad_(True) for a in args]
    plain = [a.float().requires_grad_(True) for a in args]
    before = (ops.launches(), ops.bwd_launches())
    got = torch.autograd.grad(ops.ssd(*leaves), leaves, dy)
    want = torch.autograd.grad(ssd_torch(*plain, chunk=ops.CHUNK), plain,
                               dy.float())
    torch.cuda.synchronize()
    assert (ops.launches(), ops.bwd_launches()) == (before[0] + 1,
                                                    before[1] + 1)
    for name, g, w in zip(NAMES, got, want):
        assert _excess(g, w, dtype) <= 0, f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_backward_is_bit_identical_across_calls(card, dtype):
    """The sums across blocks are per-block partials summed in order, with
    no atomics: two calls on the same inputs give the same bits."""
    args, dy = _inputs(2, 512, 80, 64, 64, "slow", True, dtype=dtype,
                       device=card)
    first = ops.ssd_bwd(*args, dy)
    second = ops.ssd_bwd(*args, dy)
    for name, a, b in zip(NAMES, first, second):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits)), f"d{name}"
