"""The port's Mamba-2 mixer and SSD scan against the JAX package's.

On the CPU: the plain SSD (``ssd_torch``) against the reference's Pallas
kernel in interpret mode and its sequential oracle, over the shapes of
``tests/test_kernels.py`` (a ragged final chunk included), f32 at 2e-3 and
bf16 at 5e-2, the reference's own tolerances, and against the reference's
``ssd_chunked`` at its 1e-4, each under the random-weight model's fast decay
and under Mamba-2's slow decay, which carries the state across chunks; then ``_split_proj``, ``_causal_conv`` and
``mamba2_layer`` (prefill and decode) against the reference on weights
carried by ``interop.lm_params_from_state``; and an emulation of the bf16
kernel's rounding (W, S and kdec x each split into bf16 hi + lo) against the
bound the kernel is held to.  On a card (``cuda`` marker, skipped without
one): the hand-written kernel against ``ssd_torch`` (bf16: the tensor-core
form ``ssd_kernel_wgmma``; f32: the CUDA-core form ``ssd_kernel``, each
checked by name under ``torch.profiler``), and its launches through
``mamba2_layer``; those tests import nothing of JAX, so they also run where
only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_mamba2.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import smoke_config
from repro_torch.kernels.mamba2_ssd import ops
from repro_torch.kernels.mamba2_ssd.ref import ssd_torch
from repro_torch.models import mamba2

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
#: the kernel against its plain version, (atol, rtol): both round f32 values
#: that agree to about 1e-6 once, so in bf16 they differ by at most one ulp,
#: 2^-7 |want| < 1e-2 |want| (chip_smoke.py holds the same bound)
KERNEL_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]
#: (B, S, H, P, N, chunk): the reference's sweep (tests/test_kernels.py)
SWEEP = [(1, 32, 2, 8, 8, 16), (2, 70, 3, 8, 12, 32), (1, 128, 2, 16, 16, 64)]


def _ids(shape):
    return "B{}-S{}-H{}-P{}-N{}-L{}".format(*shape)


#: the steps' decay: "model", dt = softplus(normal) and A_log = normal / 2,
#: the random-weight model's, under which a head's state dies within a
#: chunk; "slow", Mamba-2's initial ranges (A in [1, 16], one uniform draw
#: in each of H strata so that a head has A near 1; dt log-uniform in
#: [1e-3, 1e-1]), under which a head's state carries across chunks
DECAYS = ["model", "slow"]


def _inputs(B, S, H, P, N, dtype=torch.float32, seed=0, device="cpu",
            decay="model"):
    """x, dt, A_log, B, C, D as the model hands them over: x, B, C in
    ``dtype``, dt, A_log and D in f32, the decay as ``decay`` says."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    Bm = rng.standard_normal((B, S, N), np.float32)
    Cm = rng.standard_normal((B, S, N), np.float32)
    if decay == "model":
        dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)))
        A_log = rng.standard_normal(H) * 0.5
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H)))
        A_log = np.log(1.0 + 15.0 * (np.arange(H) + rng.random(H)) / H)
    dt, A_log = dt.astype(np.float32), A_log.astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return [torch.from_numpy(a).to(device=device,
                                   dtype=dtype if i in (0, 3, 4) else None)
            for i, a in enumerate((x, dt, A_log, Bm, Cm, D))]


def _undecayed(x, dt, A_log, B, C, D, chunk):
    """A faulty scan whose state update leaves out the carried state's
    decay (S <- (x kdec)^T B): each chunk sees the state of the chunk before
    it alone, i.e. the plain arithmetic over that pair of chunks."""
    outs = [ssd_torch(x[:, :chunk], dt[:, :chunk], A_log, B[:, :chunk],
                      C[:, :chunk], D, chunk=chunk)]
    for s0 in range(chunk, x.shape[1], chunk):
        w = slice(s0 - chunk, s0 + chunk)
        outs.append(ssd_torch(x[:, w], dt[:, w], A_log, B[:, w], C[:, w], D,
                              chunk=chunk)[:, chunk:])
    return torch.cat(outs, dim=1)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's SSD op, oracle and Mamba-2 module, and a torch ->
    jax bridge."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.mamba2_ssd.ops import ssd_op
    from repro.kernels.mamba2_ssd.ref import ssd_ref
    from repro.models import mamba2 as ref_mamba2

    def to_jax(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    return ssd_op, ssd_ref, ref_mamba2, to_jax


# ---------------------------------------------------------------------------
# the plain SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SWEEP, ids=_ids)
def test_ssd_torch_matches_pallas_interpret(ref, shape, dtype, decay):
    ssd_op, _, _, to_jax = ref
    *dims, chunk = shape
    args = _inputs(*dims, dtype=dtype, seed=1, decay=decay)
    got = ssd_torch(*args, chunk=chunk)
    want = ssd_op(*map(to_jax, args), chunk=chunk, interpret=True)
    assert got.dtype == dtype and got.shape == args[0].shape
    _close(got.float(), want.astype("float32"), TOL[dtype])


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SWEEP, ids=_ids)
def test_ssd_torch_matches_sequential_oracle(ref, shape, dtype, decay):
    _, ssd_ref, _, to_jax = ref
    *dims, chunk = shape
    args = _inputs(*dims, dtype=dtype, seed=2, decay=decay)
    got = ssd_torch(*args, chunk=chunk)
    _close(got.float(), ssd_ref(*map(to_jax, args)).astype("float32"),
           TOL[dtype])
    _close(got.float(), mamba2.ssd_sequential(*args).float(), TOL[dtype])


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SWEEP + [(2, 48, 2, 8, 8, 16)], ids=_ids)
def test_ssd_torch_matches_reference_ssd_chunked(ref, shape, decay):
    """The model's chunked SSD, which the port's CPU path runs: the same
    arithmetic in f32 (the reference's 1e-4)."""
    _, _, ref_mamba2, to_jax = ref
    *dims, chunk = shape
    args = _inputs(*dims, seed=3, decay=decay)
    got = mamba2.ssd_chunked(*args, chunk=chunk)
    want = ref_mamba2.ssd_chunked(*map(to_jax, args), chunk=chunk)
    _close(got, want, 1e-4)


def test_ssd_sequential_matches_reference(ref):
    _, _, ref_mamba2, to_jax = ref
    args = _inputs(2, 40, 3, 8, 6, seed=4)
    _close(mamba2.ssd_sequential(*args),
           ref_mamba2.ssd_sequential(*map(to_jax, args)), 1e-4)


def test_ssd_torch_guards_the_exponent_above_the_diagonal():
    """Large steps make cum_t - cum_i large and positive above the
    diagonal, where exp overflows to inf: a form that masks by multiplying
    (inf * 0 = NaN) in place of selecting would poison y."""
    x, dt, A_log, Bm, Cm, D = _inputs(1, 64, 2, 8, 8, seed=5)
    got = ssd_torch(x, dt * 200, A_log + 2, Bm, Cm, D)
    assert torch.isfinite(got).all()
    _close(got, mamba2.ssd_sequential(x, dt * 200, A_log + 2, Bm, Cm, D),
           2e-3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_slow_decay_shows_the_carried_state(dtype):
    """Under Mamba-2's slow decay the state from two chunks back still
    reaches y: a scan that leaves out its decay lies outside the kernel's
    bound against the plain version (the card tests hold the kernel to that
    bound on these inputs)."""
    args = _inputs(2, 512, 8, 16, 16, dtype=dtype, seed=12, decay="slow")
    want = ssd_torch(*args).float()
    fault = _undecayed(*args, chunk=64).float()
    atol, rtol = KERNEL_TOL[dtype]
    outside = (fault - want).abs() > atol + rtol * want.abs()
    # the first two chunks carry no decayed state: the fault shows after
    assert not outside[:, :128].any() and outside[:, 128:].any()


#: the bf16 kernel's operands that are f32 values, each of which it splits
#: into bf16 hi + lo: W (the intra-chunk weights), S (the carried state) and
#: kdec x (the state update's left-hand side, x's rows scaled by kdec)
SPLIT = ("W", "S", "kdecx")


def _bf16(t):
    return t.bfloat16().float()


def kernel_rounding(x, dt, A_log, B, C, D, chunk=64, split=SPLIT):
    """The bf16 tensor-core form's arithmetic on the CPU, chunk by chunk:
    every product takes bf16 operands and sums in f32; x, B and C are bf16
    already; W (with D on its diagonal, which carries the D x skip), S and
    kdec x enter as bf16 hi + lo (hi = bf16(v), lo = bf16(v - hi)) where
    ``split`` names them and rounded once to bf16 where it does not;
    y = exp(cum) (C S^T) + (W + D I) x in f32, rounded once."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    n = -(-S // chunk)
    pad = n * chunk - S
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, n, chunk, H, P)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, H)
    Bc = F.pad(B.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    Cc = F.pad(C.float(), (0, 0, 0, pad)).reshape(Bsz, n, chunk, N)
    lac = -dtc * torch.exp(A_log.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))[
        None, :, :, None]
    skip = torch.eye(chunk)[None, :, :, None] * D.float()    # D on the diagonal

    def parts(v, name):
        hi = _bf16(v)
        return (hi, _bf16(v - hi)) if name in split else (hi,)

    state = torch.zeros((Bsz, H, P, N))
    ys = []
    for c in range(n):
        xb, dtb, Bb, Cb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(lac[:, c], dim=1)                  # (B, L, H)
        y = sum(torch.einsum("bhpn,bln->blhp", s, Cb)
                for s in parts(state, "S")) * torch.exp(cum)[..., None]
        expo = cum[:, :, None, :] - cum[:, None, :, :]
        g = torch.where(tri, torch.exp(torch.where(tri, expo, 0.0)), 0.0)
        w = g * torch.einsum("bln,bin->bli", Cb, Bb)[..., None] \
            * dtb[:, None, :, :] + skip                       # (B, L, L, H)
        y = y + sum(torch.einsum("blih,bihp->blhp", wp, xb)
                    for wp in parts(w, "W"))
        ys.append(y)
        k_dec = torch.exp(cum[:, -1:, :] - cum) * dtb         # (B, L, H)
        kx = k_dec[..., None] * xb                            # (B, L, H, P)
        state = state * torch.exp(cum[:, -1])[..., None, None] + sum(
            torch.einsum("blhp,bln->bhpn", kp, Bb)
            for kp in parts(kx, "kdecx"))
    y = torch.stack(ys, dim=1).reshape(Bsz, n * chunk, H, P)[:, :S]
    return y.to(x.dtype)


def _outside(got, want):
    """How many elements of ``got`` lie outside ``KERNEL_TOL[bf16]`` of
    ``want``."""
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    want = want.float()
    return int(((got.float() - want).abs() > atol + rtol * want.abs()).sum())


#: zamba2's prefill shape: B = 2 prompts of 2048 steps, 80 heads of 64,
#: state 64
PREFILL = (2, 2048, 80, 64, 64)


@pytest.mark.parametrize("decay", DECAYS)
def test_kernel_rounding_meets_the_kernel_bound(decay):
    """With W, S and kdec x each split into bf16 hi + lo, the bf16 kernel's
    arithmetic stays within ``KERNEL_TOL[bf16]`` of the plain version in
    every element at the main path's shape."""
    args = _inputs(*PREFILL, dtype=torch.bfloat16, seed=11, decay=decay)
    got = kernel_rounding(*args)
    want = ssd_torch(*args)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("operand", SPLIT)
def test_rounding_one_operand_once_leaves_the_bound(operand, decay):
    """Why the kernel splits each of the three: with that operand rounded
    once to bf16 (the other two split), outputs at the main path's shape
    fall outside ``KERNEL_TOL[bf16]`` of the plain version."""
    args = _inputs(*PREFILL, dtype=torch.bfloat16, seed=11, decay=decay)
    got = kernel_rounding(*args, split=tuple(o for o in SPLIT
                                             if o != operand))
    assert _outside(got, ssd_torch(*args)) > 0


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing():
    args = _inputs(2, 70, 3, 8, 12, dtype=torch.bfloat16, seed=6)
    before = ops.launches()
    got = ops.ssd(*args)
    assert ops.launches() == before
    assert torch.equal(got, ssd_torch(*args))


@pytest.mark.parametrize("change,match", [
    (lambda a: [a[0][0]] + a[1:], "(B, S, H, P)"),
    (lambda a: a[:1] + [a[1][:, :-1]] + a[2:], "dt has shape"),
    (lambda a: a[:2] + [a[2][:-1]] + a[3:], "A_log has shape"),
    (lambda a: a[:3] + [a[3][..., :-1]] + a[4:], "C has shape"),
    (lambda a: a[:5] + [a[5][None]], "D has shape"),
    (lambda a: a[:3] + [a[3].tolist()] + a[4:], "torch.Tensor"),
    (lambda a: [t[:, :0] for t in a[:2]] + a[2:3]
     + [t[:, :0] for t in a[3:5]] + a[5:], "empty"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    args = _inputs(1, 16, 2, 8, 4)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.ssd(*change(args))


# ---------------------------------------------------------------------------
# the Mamba-2 mixer on the reference's weights
# ---------------------------------------------------------------------------

#: name -> (jax dtype name, torch dtype, tolerance)
MODEL_DTYPES = {"f32": ("float32", torch.float32, 2e-3),
                "bf16": ("bfloat16", torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module")
def zamba2_layers(ref):
    """(reference cfg, reference layer-0 weights, port cfg, port layer-0
    weights) of zamba2's smoke config, per dtype, on the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.common import init_params as ref_init_params

    from repro_torch.interop import lm_params_from_state
    out = {}
    for name, (jdt, tdt, _) in MODEL_DTYPES.items():
        rcfg = ref_smoke_config("zamba2-2.7b").scaled(dtype=getattr(jnp, jdt))
        pcfg = smoke_config("zamba2-2.7b").scaled(dtype=tdt)
        rparams = ref_init_params(jax.random.PRNGKey(0), rcfg)
        pparams = lm_params_from_state(jax.tree.map(np.asarray, rparams),
                                       pcfg, "cpu")
        rlayer = jax.tree.map(lambda w: w[0], rparams["mamba"])
        out[name] = rcfg, rlayer, pcfg, pparams["layers"][0]
    return out


def test_split_proj_matches_reference(ref, zamba2_layers):
    """The fused projection splits in the order (x, gate, B, C, dt)."""
    _, _, ref_mamba2, _ = ref
    rcfg, _, pcfg, _ = zamba2_layers["f32"]
    H, P, N, d_in = pcfg.ssm_dims()
    z = np.random.default_rng(7).standard_normal(
        (2, 5, 2 * d_in + 2 * N + H)).astype(np.float32)
    got = mamba2._split_proj(torch.from_numpy(z), pcfg)
    want = ref_mamba2._split_proj(z, rcfg)
    assert got[5:] == tuple(want[5:]) == (H, P, N, d_in)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dt", MODEL_DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(ref, zamba2_layers, dt, with_state):
    _, _, ref_mamba2, to_jax = ref
    _, rlayer, pcfg, player = zamba2_layers[dt]
    tdt, tol = MODEL_DTYPES[dt][1:]
    rng = np.random.default_rng(8)
    C = player["conv_w"].shape[1]
    x = torch.from_numpy(rng.standard_normal((2, 9, C), np.float32)).to(tdt)
    state = (torch.from_numpy(rng.standard_normal((2, pcfg.ssm_conv - 1, C),
                                                  np.float32)).to(tdt)
             if with_state else None)
    got, got_state = mamba2._causal_conv(x, player["conv_w"], state)
    want, want_state = ref_mamba2._causal_conv(
        to_jax(x), rlayer["conv_w"], None if state is None else to_jax(state))
    assert got.dtype == tdt and got_state.shape == (2, pcfg.ssm_conv - 1, C)
    _close(got.float(), np.asarray(want, np.float32), tol)
    _close(got_state.float(), np.asarray(want_state, np.float32), tol)


@pytest.mark.parametrize("dt", MODEL_DTYPES)
def test_mamba2_layer_prefill_matches_reference(ref, zamba2_layers, dt):
    import jax
    _, _, ref_mamba2, to_jax = ref
    rcfg, rlayer, pcfg, player = zamba2_layers[dt]
    tdt, tol = MODEL_DTYPES[dt][1:]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 70, pcfg.d_model), np.float32)).to(tdt)
    got, conv, ssm = mamba2.mamba2_layer(x, player, pcfg)
    want, rconv, _ = jax.jit(ref_mamba2.mamba2_layer, static_argnums=2)(
        to_jax(x), rlayer, rcfg)
    assert got.dtype == tdt and got.shape == x.shape and ssm is None
    _close(got.float(), np.asarray(want, np.float32), tol)
    _close(conv.float(), np.asarray(rconv, np.float32), tol)


@pytest.mark.parametrize("dt", MODEL_DTYPES)
def test_mamba2_layer_decode_matches_reference(ref, zamba2_layers, dt):
    """Eight decode steps from a random (conv, state) cache, each step's
    output and both caches against the reference's."""
    import jax
    _, _, ref_mamba2, to_jax = ref
    rcfg, rlayer, pcfg, player = zamba2_layers[dt]
    tdt, tol = MODEL_DTYPES[dt][1:]
    H, P, N, d_in = pcfg.ssm_dims()
    rng = np.random.default_rng(10)
    conv = torch.from_numpy(rng.standard_normal(
        (2, pcfg.ssm_conv - 1, d_in + 2 * N), np.float32)).to(tdt)
    ssm = torch.from_numpy(rng.standard_normal((2, H, P, N), np.float32))
    rconv, rssm = to_jax(conv), to_jax(ssm)
    step = jax.jit(lambda x, c, s: ref_mamba2.mamba2_layer(
        x, rlayer, rcfg, conv_state=c, ssm_state=s, decode=True))
    for _ in range(8):
        x = torch.from_numpy(rng.standard_normal(
            (2, 1, pcfg.d_model), np.float32)).to(tdt)
        got, conv, ssm = mamba2.mamba2_layer(x, player, pcfg, conv_state=conv,
                                             ssm_state=ssm, decode=True)
        want, rconv, rssm = step(to_jax(x), rconv, rssm)
        assert got.dtype == tdt and ssm.dtype == torch.float32
        _close(got.float(), np.asarray(want, np.float32), tol)
        _close(conv.float(), np.asarray(rconv, np.float32), tol)
        _close(ssm, np.asarray(rssm), tol)


def test_decode_steps_continue_the_prefill():
    """The recurrent form run one token at a time ends where the chunked
    form does: conv windows equal, outputs within f32 rounding."""
    cfg = smoke_config("zamba2-2.7b").scaled(dtype=torch.float32)
    from repro_torch.models.common import init_params
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")["layers"][0]
    H, P, N, d_in = cfg.ssm_dims()
    x = torch.randn((2, 20, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, want_conv, _ = mamba2.mamba2_layer(x, p, cfg)
    conv = torch.zeros((2, cfg.ssm_conv - 1, d_in + 2 * N))
    ssm = torch.zeros((2, H, P, N))
    outs = []
    for t in range(20):
        y, conv, ssm = mamba2.mamba2_layer(x[:, t:t + 1], p, cfg, conv, ssm,
                                           decode=True)
        outs.append(y)
    _close(torch.cat(outs, dim=1), want, 1e-4)
    assert torch.equal(conv, want_conv)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mamba2_ssd kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: (B, S, H, P, N): zamba2's prefill shape, its heads at a ragged length,
#: B = 1 and 2, one chunk and less, P != N, and the reference's sweep
CARD_SHAPES = [(2, 2048, 80, 64, 64), (2, 300, 80, 64, 64),
               (1, 2000, 80, 64, 64), (1, 64, 4, 64, 64), (3, 37, 5, 32, 16),
               (2, 130, 3, 16, 48)] + [s[:5] for s in SWEEP]


@pytest.mark.cuda
@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "B{}-S{}-H{}-P{}-N{}".format(*s))
def test_kernel_matches_plain_version(card, shape, dtype, decay):
    args = _inputs(*shape, dtype=dtype, seed=11, device=card, decay=decay)
    before = ops.launches()
    got = ops.ssd(*args)
    torch.cuda.synchronize()
    assert ops.launches() == before + 1
    want = ssd_torch(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    atol, rtol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


def _ssd_kernels_run(fn, attempts=3):
    """The names of the SSD kernels (device kernels whose name holds
    "ssd_kernel") that ``fn`` launches, under ``torch.profiler``.  A short
    profile now and then records no device event at all, so it is taken
    again, up to ``attempts`` times, until it records one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = set()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()
                 if ev.device_type != DeviceType.CPU
                 and "ssd_kernel" in ev.key}
        if names:
            break
    return names


def _assert_form(names, dtype):
    """bf16 runs the tensor-core form alone, f32 the CUDA-core form."""
    assert names, "no SSD kernel ran"
    if dtype == torch.bfloat16:
        assert all("ssd_kernel_wgmma" in n for n in names), names
    else:
        assert not any("wgmma" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "B{}-S{}-H{}-P{}-N{}".format(*s))
def test_kernel_runs_the_form_of_its_dtype(card, shape, dtype):
    """bf16 runs ``ssd_kernel_wgmma`` (a state of 12 through a padded copy),
    f32 ``ssd_kernel``, by the names the profiler sees."""
    args = _inputs(*shape, dtype=dtype, seed=11, device=card, decay="slow")
    _assert_form(_ssd_kernels_run(lambda: ops.ssd(*args)), dtype)


@pytest.mark.cuda
def test_bf16_kernel_copies_what_tma_cannot_read(card):
    """x at an offset off 16 bytes and a contiguous state of 12 (rows of 24
    bytes) break TMA's rules: the wrapper copies them, zero-padded, and
    still launches the tensor-core form, once."""
    x, dt, A_log, Bm, Cm, D = _inputs(2, 130, 3, 16, 12, dtype=torch.bfloat16,
                                      device=card, decay="slow")
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert shifted.data_ptr() % 16 and Bm.stride(1) * 2 % 16
    before = ops.launches()
    names = _ssd_kernels_run(lambda: ops.ssd(shifted, dt, A_log, Bm, Cm, D))
    _assert_form(names, torch.bfloat16)
    assert ops.launches() == before + 1
    got = ops.ssd(shifted, dt, A_log, Bm, Cm, D)
    want = ssd_torch(x, dt, A_log, Bm, Cm, D)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 100, 6, 16, 8), (2, 300, 80, 64, 64)],
                         ids=["small", "zamba2-widths"])
def test_kernel_reads_strided_views(card, shape):
    """The model hands in x, B and C as views of the conv output: rows of
    H P + 2 N elements, B and C at H P and H P + N (at zamba2's widths rows
    of 10,496 bytes, B at byte 10,240 and C at 10,368), read in place."""
    B, S, H, P, N = shape
    x, dt, A_log, _, _, D = _inputs(B, S, H, P, N, dtype=torch.bfloat16,
                                    device=card, decay="slow")
    conv = torch.randn((B, S, H * P + 2 * N), device=card).bfloat16()
    xv, Bv, Cv = torch.split(conv, [H * P, N, N], dim=-1)
    xv = xv.reshape(B, S, H, P)
    assert not xv.is_contiguous() and not Bv.is_contiguous()
    assert all(ops._tma_readable(t) is t for t in (xv, Bv, Cv))
    _assert_form(_ssd_kernels_run(lambda: ops.ssd(xv, dt, A_log, Bv, Cv, D)),
                 torch.bfloat16)
    got = ops.ssd(xv, dt, A_log, Bv, Cv, D)
    want = ssd_torch(xv.contiguous(), dt, A_log, Bv.contiguous(),
                     Cv.contiguous(), D)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    args = _inputs(1, 16, 2, 128, 8, device=card)
    with pytest.raises(ValueError, match="at most 64"):
        ops.ssd(*args)
    args = _inputs(1, 16, 2, 8, 8, device=card)
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd(args[0].double(), *args[1:])


@pytest.mark.cuda
def test_mamba2_layer_launches_the_kernel_in_prefill_only(card):
    cfg = smoke_config("zamba2-2.7b").scaled(dtype=torch.float32)
    from repro_torch.models.common import init_params
    p = init_params(torch.Generator(device=card).manual_seed(0), cfg,
                    card)["layers"][0]
    x = torch.randn((2, 70, cfg.d_model), device=card)
    ops.reset_launches()
    got, _, _ = mamba2.mamba2_layer(x, p, cfg)
    torch.cuda.synchronize()
    assert ops.launches() == 1
    cpu_p = {k: v.cpu() for k, v in p.items()}
    want, _, _ = mamba2.mamba2_layer(x.cpu(), cpu_p, cfg)
    _close(got.cpu(), want, 2e-3)
    H, P, N, d_in = cfg.ssm_dims()
    mamba2.mamba2_layer(x[:, :1], p, cfg,
                        torch.zeros((2, cfg.ssm_conv - 1, d_in + 2 * N),
                                    device=card),
                        torch.zeros((2, H, P, N), device=card), decode=True)
    assert ops.launches() == 1
