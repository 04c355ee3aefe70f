"""The port's RWKV-6 block and WKV against the JAX package's.

On the CPU: the plain chunked WKV (``wkv6_torch``) against the reference's
Pallas kernel in interpret mode and its sequential oracle, over the shapes
of ``tests/test_kernels.py`` (ragged final chunks included) and K = 64, f32
at 2e-3 and bf16 at 5e-2, the reference's own tolerances, and against the
reference's ``wkv6_chunked`` at its 1e-4.  Every decay draw is "mixed" (the
even channels in the model's own slow range, the odd ones fast) or "slow"
(every channel slow): under the slow decay the (K, K) state carries across
chunks, so a WKV that drops or leaves undecayed the carried state lies
outside the kernel's bound, as does one without the ``u`` bonus.  Then
``_proj_rkvwg``, ``rwkv6_layer`` and ``rwkv6_decode_step`` against the
reference on weights carried by ``interop.lm_params_from_state``.  On a card
(``cuda`` marker, skipped without one): the hand-written kernel against
``wkv6_torch``, strided views, rejections, and its launches through
``rwkv6_layer``; those tests import nothing of JAX, so they also run where
only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_rwkv6.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import smoke_config
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref, wkv6_torch
from repro_torch.models import layers, rwkv6

TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
#: the kernel against its plain version, (atol, rtol): both round f32 values
#: that agree to about 1e-6 once, so in bf16 they differ by at most one ulp,
#: 2^-7 |want| < 1e-2 |want| (chip_smoke.py holds the same bound)
KERNEL_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]
#: (B, S, H, K, chunk): the reference's sweep (tests/test_kernels.py) and
#: rwkv6-1.6b's head width
SWEEP = [(1, 32, 2, 8, 16), (2, 70, 3, 16, 32), (1, 128, 1, 64, 32),
         (2, 33, 4, 8, 32), (1, 128, 2, 64, 32)]
#: "slow": log_w = -exp(-5 + N(0, 0.5^2)), about -0.0067 a step, the model's
#: own range at its initialisation (w_bias = -5, ww at 0.01), under which
#: the state decays by about 0.81 over a chunk and carries across chunks;
#: "mixed": the even channels slow, the odd ones -exp(N(0, 1)), about -1 a
#: step (the reference kernel tests' draw), under which the state dies
#: within a chunk.  Both clamped at LOG_W_MIN = -8
DECAYS = ["mixed", "slow"]


def _ids(shape):
    return "B{}-S{}-H{}-K{}-L{}".format(*shape)


def _log_w(rng, shape, decay):
    slow = -np.exp(-5.0 + 0.5 * rng.standard_normal(shape))
    fast = -np.exp(rng.standard_normal(shape))
    if decay == "mixed":
        slow = np.where(np.arange(shape[-1]) % 2 == 0, slow, fast)
    return np.maximum(slow, rwkv6.LOG_W_MIN).astype(np.float32)


def _inputs(B, S, H, K, dtype=torch.float32, seed=0, device="cpu",
            decay="mixed"):
    """r, k, v, log_w, u as the model hands them over: r, k, v in
    ``dtype``, log_w in f32, u (H, K) in ``dtype``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K), np.float32)
               for _ in range(3))
    log_w = _log_w(rng, (B, S, H, K), decay)
    u = (0.5 * rng.standard_normal((H, K))).astype(np.float32)
    return [torch.from_numpy(a).to(device=device,
                                   dtype=torch.float32 if i == 3 else dtype)
            for i, a in enumerate((r, k, v, log_w, u))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# the planted faults: what a faulty kernel returns, from the plain arithmetic

def _dropped_state(r, k, v, log_w, u, at, chunk):
    """The carried state zeroed at step ``at`` (a chunk boundary): the
    plain arithmetic restarted there.  Covers steps ``at`` on."""
    return wkv6_torch(r[:, at:], k[:, at:], v[:, at:], log_w[:, at:], u,
                      chunk=chunk)


def _undecayed_state(r, k, v, log_w, u, chunk):
    """The state update without its term diag(exp(cum_L)) S: each chunk
    sees the state of the chunk before it alone, i.e. the plain arithmetic
    over that pair of chunks from a zero state."""
    outs = [wkv6_torch(r[:, :chunk], k[:, :chunk], v[:, :chunk],
                       log_w[:, :chunk], u, chunk=chunk)]
    for s0 in range(chunk, r.shape[1], chunk):
        w = slice(s0 - chunk, s0 + chunk)
        outs.append(wkv6_torch(r[:, w], k[:, w], v[:, w], log_w[:, w], u,
                               chunk=chunk)[:, chunk:])
    return torch.cat(outs, dim=1)


def _no_bonus(r, k, v, log_w, u, chunk):
    """o_diag left out: the u bonus set to zero."""
    return wkv6_torch(r, k, v, log_w, torch.zeros_like(u), chunk=chunk)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's WKV op, oracle and RWKV-6 module, and a torch ->
    jax bridge."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rwkv6.ops import wkv6_op
    from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
    from repro.models import rwkv6 as ref_rwkv6

    def to_jax(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    return wkv6_op, jax_wkv6_ref, ref_rwkv6, to_jax


# ---------------------------------------------------------------------------
# the plain WKV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SWEEP, ids=_ids)
def test_wkv6_torch_matches_pallas_interpret(ref, shape, dtype, decay):
    wkv6_op, _, _, to_jax = ref
    *dims, chunk = shape
    args = _inputs(*dims, dtype=dtype, seed=1, decay=decay)
    got = wkv6_torch(*args, chunk=chunk)
    want = wkv6_op(*map(to_jax, args), chunk=chunk, interpret=True)
    assert got.dtype == dtype and got.shape == args[0].shape
    _close(got.float(), want.astype("float32"), TOL[dtype])


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SWEEP, ids=_ids)
def test_wkv6_torch_matches_sequential_oracle(ref, shape, dtype, decay):
    _, jax_wkv6_ref, _, to_jax = ref
    *dims, chunk = shape
    args = _inputs(*dims, dtype=dtype, seed=2, decay=decay)
    got = wkv6_torch(*args, chunk=chunk).float()
    _close(got, jax_wkv6_ref(*map(to_jax, args)).astype("float32"),
           TOL[dtype])
    _close(got, wkv6_ref(*args).float(), TOL[dtype])


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SWEEP + [(2, 48, 2, 8, 32)], ids=_ids)
def test_wkv6_torch_matches_reference_wkv6_chunked(ref, shape, decay):
    """The model's chunked WKV, which the port's CPU path runs: the same
    arithmetic in f32 (the reference's 1e-4)."""
    _, _, ref_rwkv6, to_jax = ref
    *dims, chunk = shape
    args = _inputs(*dims, seed=3, decay=decay)
    got = rwkv6.wkv6_chunked(*args, chunk=chunk)
    want = ref_rwkv6.wkv6_chunked(*map(to_jax, args), chunk=chunk)
    _close(got, want, 1e-4)


def test_wkv6_sequential_matches_reference(ref):
    _, _, ref_rwkv6, to_jax = ref
    args = _inputs(2, 40, 3, 8, seed=4, decay="slow")
    got = rwkv6.wkv6_sequential(*args)
    assert got.dtype == torch.float32
    _close(got, ref_rwkv6.wkv6_sequential(*map(to_jax, args)), 1e-4)


def test_wkv6_torch_guards_the_exponent_above_the_diagonal():
    """With every log_w at LOG_W_MIN a chunk's cum reaches -256, so above
    the diagonal exp(cum_ex_t - cum_i) is exp(+248) = inf: a form that masks
    after the exp (inf * 0 = NaN) or factors the exponent would poison o."""
    r, k, v, _, u = _inputs(1, 64, 2, 8, seed=5)
    log_w = torch.full_like(r, rwkv6.LOG_W_MIN)
    got = wkv6_torch(r, k, v, log_w, u)
    assert torch.isfinite(got).all()
    _close(got, wkv6_ref(r, k, v, log_w, u), 2e-3)


@pytest.mark.parametrize("fault", ["dropped_state", "undecayed_state",
                                   "no_bonus"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_planted_faults_lie_outside_the_kernel_bound(dtype, fault):
    """Under the slow decay the state from two chunks back still reaches o:
    each planted fault lies outside the kernel's bound against the plain
    version (the card tests and chip_smoke.py hold the kernel to that bound
    on these decays), the state faults only after the chunks they spare."""
    chunk, at = 32, 128
    args = _inputs(2, 256, 4, 16, dtype=dtype, seed=12, decay="slow")
    want = wkv6_torch(*args, chunk=chunk).float()
    got, spared = {
        "dropped_state": lambda: (_dropped_state(*args, at, chunk), 0),
        "undecayed_state": lambda: (_undecayed_state(*args, chunk),
                                    2 * chunk),
        "no_bonus": lambda: (_no_bonus(*args, chunk), 0),
    }[fault]()
    first = at if fault == "dropped_state" else 0
    atol, rtol = KERNEL_TOL[dtype]
    outside = ((got.float() - want[:, first:]).abs()
               > atol + rtol * want[:, first:].abs())
    assert not outside[:, :spared].any() and outside[:, spared:].any()


def test_sigmoid_and_silu_match_the_reference_bit_for_bit(ref):
    """In bf16 the reference's jitted sigmoid and silu round after every
    step (negate, exp, add 1, divide); so do the port's written-out forms,
    which the RWKV-6 block takes.  ``torch.sigmoid`` rounds once and
    differs from them in about a third of these values."""
    import jax
    _, _, _, to_jax = ref
    x = torch.from_numpy((3 * np.random.default_rng(0).standard_normal(
        100_000)).astype(np.float32)).bfloat16()
    for port, jax_fn in ((layers.sigmoid, jax.nn.sigmoid),
                         (layers.silu, jax.nn.silu)):
        np.testing.assert_array_equal(
            port(x).float().numpy(),
            np.asarray(jax.jit(jax_fn)(to_jax(x)), np.float32))
    assert (torch.sigmoid(x) != layers.sigmoid(x)).float().mean() > 0.3


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing():
    args = _inputs(2, 70, 3, 16, dtype=torch.bfloat16, seed=6)
    before = ops.launches()
    got = ops.wkv6(*args)
    assert ops.launches() == before
    assert torch.equal(got, wkv6_torch(*args, chunk=ops.CHUNK))


@pytest.mark.parametrize("change,match", [
    (lambda a: [a[0][0]] + a[1:], "(B, S, H, K)"),
    (lambda a: a[:1] + [a[1][:, :-1]] + a[2:], "k has shape"),
    (lambda a: a[:2] + [a[2][..., :-1]] + a[3:], "v has shape"),
    (lambda a: a[:3] + [a[3][:, :, :1]] + a[4:], "log_w has shape"),
    (lambda a: a[:4] + [a[4][None]], "u has shape"),
    (lambda a: a[:2] + [a[2].tolist()] + a[3:], "torch.Tensor"),
    (lambda a: [t[:, :0] for t in a[:4]] + a[4:], "empty"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    args = _inputs(1, 16, 2, 8)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.wkv6(*change(args))


# ---------------------------------------------------------------------------
# the RWKV-6 block on the reference's weights
# ---------------------------------------------------------------------------

#: name -> (jax dtype name, torch dtype, tolerance)
MODEL_DTYPES = {"f32": ("float32", torch.float32, 2e-3),
                "bf16": ("bfloat16", torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module")
def rwkv6_layers(ref):
    """(reference cfg, reference layer-0 weights, port cfg, port layer-0
    weights) of rwkv6's smoke config, per dtype, on the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.common import init_params as ref_init_params

    from repro_torch.interop import lm_params_from_state
    out = {}
    for name, (jdt, tdt, _) in MODEL_DTYPES.items():
        rcfg = ref_smoke_config("rwkv6-1.6b").scaled(dtype=getattr(jnp, jdt))
        pcfg = smoke_config("rwkv6-1.6b").scaled(dtype=tdt)
        rparams = ref_init_params(jax.random.PRNGKey(0), rcfg)
        pparams = lm_params_from_state(jax.tree.map(np.asarray, rparams),
                                       pcfg, "cpu")
        rlayer = jax.tree.map(lambda w: w[0], rparams["rwkv"])
        out[name] = rcfg, rlayer, pcfg, pparams["layers"][0]
    return out


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dtype)


def _reference(fn, dt, **jit_kw):
    """``fn`` as the reference runs it: jitted in f32; in bf16 op by op
    (``jax.disable_jit``).  Under ``jit`` XLA rounds the bf16 block at
    other places (for one, it adds ``w_bias`` to the bf16 product in f32,
    so the log decay is never rounded to bf16: 1.5e-4, 2%, apart), and the
    jitted reference ends up to 0.19 from its own eager run in 10 of the
    8,960 outputs of one block (2 x 70 tokens, beyond 5e-2), while the port
    follows the eager run bit for bit (ROADMAP Queue C)."""
    import jax
    if dt == "f32":
        return jax.jit(fn, **jit_kw)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


@pytest.mark.parametrize("dt", MODEL_DTYPES)
def test_proj_rkvwg_matches_reference(ref, rwkv6_layers, dt):
    _, _, ref_rwkv6, to_jax = ref
    _, rlayer, pcfg, player = rwkv6_layers[dt]
    tdt, tol = MODEL_DTYPES[dt][1:]
    rng = np.random.default_rng(7)
    x = _randn(rng, (2, 9, pcfg.d_model), tdt)
    x_prev = _randn(rng, (2, pcfg.d_model), tdt)
    got = rwkv6._proj_rkvwg(x, x_prev, player)
    want = _reference(ref_rwkv6._proj_rkvwg, dt)(to_jax(x), to_jax(x_prev),
                                                 rlayer)
    for name, g, w in zip("r k v log_w g".split(), got, want):
        assert g.dtype == (torch.float32 if name == "log_w" else tdt), name
        _close(g.float(), np.asarray(w, np.float32), tol)
    assert bool((got[3] <= 0).all() and (got[3] >= rwkv6.LOG_W_MIN).all())


@pytest.mark.parametrize("dt", MODEL_DTYPES)
def test_rwkv6_layer_prefill_matches_reference(ref, rwkv6_layers, dt):
    _, _, ref_rwkv6, to_jax = ref
    rcfg, rlayer, pcfg, player = rwkv6_layers[dt]
    tdt, tol = MODEL_DTYPES[dt][1:]
    rng = np.random.default_rng(9)
    x = _randn(rng, (2, 70, pcfg.d_model), tdt)
    tmix, cmix = (_randn(rng, (2, pcfg.d_model), tdt) for _ in range(2))
    got = rwkv6.rwkv6_layer(x, tmix, cmix, player, pcfg)
    want = _reference(ref_rwkv6.rwkv6_layer, dt, static_argnums=4)(
        to_jax(x), to_jax(tmix), to_jax(cmix), rlayer, rcfg)
    assert got[0].dtype == tdt and got[0].shape == x.shape
    for g, w in zip(got, want):
        _close(g.float(), np.asarray(w, np.float32), tol)


@pytest.mark.parametrize("dt", MODEL_DTYPES)
def test_rwkv6_decode_step_matches_reference(ref, rwkv6_layers, dt):
    """Eight decode steps from random (token-shift, channel-mix, WKV)
    states, each step's output and the three states against the
    reference's."""
    _, _, ref_rwkv6, to_jax = ref
    rcfg, rlayer, pcfg, player = rwkv6_layers[dt]
    tdt, tol = MODEL_DTYPES[dt][1:]
    H, K = pcfg.n_heads, pcfg.d_model // pcfg.n_heads
    rng = np.random.default_rng(10)
    tmix, cmix = (_randn(rng, (2, pcfg.d_model), tdt) for _ in range(2))
    wkv = _randn(rng, (2, H, K, K), torch.float32)
    rstate = tuple(map(to_jax, (tmix, cmix, wkv)))
    step = _reference(lambda x, t, c, s: ref_rwkv6.rwkv6_decode_step(
        x, t, c, s, rlayer, rcfg), dt)
    for _ in range(8):
        x = _randn(rng, (2, pcfg.d_model), tdt)
        got, tmix, cmix, wkv = rwkv6.rwkv6_decode_step(x, tmix, cmix, wkv,
                                                       player, pcfg)
        want, *rstate = step(to_jax(x), *rstate)
        assert got.dtype == tdt and wkv.dtype == torch.float32
        _close(got.float(), np.asarray(want, np.float32), tol)
        for g, w in zip((tmix, cmix, wkv), rstate):
            _close(g.float(), np.asarray(w, np.float32), tol)


def test_decode_steps_continue_the_prefill():
    """The recurrent form run one token at a time ends where the chunked
    form does: outputs and the last token's states within f32 rounding."""
    cfg = smoke_config("rwkv6-1.6b").scaled(dtype=torch.float32)
    from repro_torch.models.common import init_params
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")["layers"][0]
    H, K = cfg.n_heads, cfg.d_model // cfg.n_heads
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    tmix0, cmix0 = (torch.randn((2, cfg.d_model), generator=gen)
                    for _ in range(2))
    want, want_tmix, want_cmix = rwkv6.rwkv6_layer(x, tmix0, cmix0, p, cfg)
    tmix, cmix = tmix0, cmix0
    wkv = torch.zeros((2, H, K, K))
    outs = []
    for t in range(40):
        y, tmix, cmix, wkv = rwkv6.rwkv6_decode_step(x[:, t], tmix, cmix,
                                                     wkv, p, cfg)
        outs.append(y)
    _close(torch.stack(outs, dim=1), want, 1e-4)
    _close(tmix, want_tmix, 1e-5)
    _close(cmix, want_cmix, 1e-5)


# ---------------------------------------------------------------------------
# the bf16 tensor-core form's arithmetic, on the CPU
# ---------------------------------------------------------------------------

#: the bf16 form's chunk (``csrc/wkv6_wgmma.cu``, as ``ops.FORM_CHUNK``
#: states it) and the sub-chunk of its intra-chunk products
WG_CHUNK, WG_SUB = ops.FORM_CHUNK[torch.bfloat16], 16
#: the most a sub-chunk's cum may fall, in log2 units, for the bf16 form to
#: form a chunk's diagonal sub-blocks as products (its ``kRange``): where
#: it falls further in any channel of a (batch, head), that chunk's are
#: formed per (t, i, d)
WG_RANGE = 100.0
LOG2E = 1.4426950408889634
#: the f32 operands the bf16 form splits into bf16 hi + lo: "R" and "Kt",
#: the two sides of A's off-diagonal sub-blocks (r and k scaled from the
#: sub-chunk's reference point), "A" (A v), "rt" (r exp(cum_ex), the left
#: side of o_state), "S" (the carried state) and "kdec" (the state
#: update's left side)
SPLIT = ("R", "Kt", "A", "rt", "S", "kdec")


def _bf16(t):
    return t.bfloat16().float()


def _slow_chunks(log_w):
    """(B, chunks, H): whether the bf16 form forms the chunk's diagonal
    sub-blocks per (t, i, d), by its own test: the cum of log_w, in log2
    units, falls more than ``WG_RANGE`` over one of the chunk's sub-chunks
    in some channel."""
    B, S, H, K = log_w.shape
    n = -(-S // WG_CHUNK)
    lw = F.pad(log_w.float(), (0, 0, 0, 0, 0, n * WG_CHUNK - S))
    cum = torch.cumsum(lw.reshape(B, n, WG_CHUNK, H, K) * LOG2E, dim=2)
    ends = cum[:, :, WG_SUB - 1::WG_SUB]                 # c_0 .. c_3
    fall = F.pad(ends, (0, 0, 0, 0, 1, 0))[:, :, :-1] - ends
    return (fall > WG_RANGE).any(dim=4).any(dim=2)


def kernel_rounding(r, k, v, log_w, u, split=SPLIT, exact=False):
    """The bf16 tensor-core form's arithmetic on the CPU, chunk by chunk
    (chunks of ``WG_CHUNK``): A's sub-blocks below the diagonal (sub-chunks
    of ``WG_SUB``) as products of r_t exp(cum_ex_t - c_j) and k_i exp(c_j -
    cum_i), c_j the cum of sub-chunk j's last step, both exponents <= 0;
    the four diagonal sub-blocks as the same products with j = p (rows at
    or after the column dropped), or per (t, i, d) in a chunk where
    ``_slow_chunks`` says the kernel forms them so, with the u bonus on the
    diagonal; o = r exp(cum_ex) S + A v; S <- exp(cum_L) S + kdec^T v.
    Every product takes bf16 operands and sums in f32: r, k and v are bf16
    already, and each f32 operand enters as bf16 hi + lo (hi = bf16(x),
    lo = bf16(x - hi); the product of two split operands drops lo * lo)
    where ``split`` names it and rounded once to bf16 where it does not.
    The output is rounded once to r's dtype.  With ``exact`` nothing is
    rounded (the factorisation alone, in f32, output in f32)."""
    B, S, H, K = r.shape
    L = WG_CHUNK
    n = -(-S // L)
    pad = n * L - S

    def padc(x):
        return F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, K)
    rc, kc, vc, lwc = map(padc, (r, k, v, log_w))
    uf = u.float()

    def parts(x, name):
        if exact:
            return (x,)
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if name in split else (hi,)

    def prod(eq, a, a_name, b, b_name):
        pa, pb = parts(a, a_name), parts(b, b_name)
        return sum(torch.einsum(eq, x, y) for m, x in enumerate(pa)
                   for q, y in enumerate(pb) if m + q < 2)

    tri = torch.tril(torch.ones((WG_SUB, WG_SUB), dtype=torch.bool),
                     -1)[None, :, :, None]
    eye = torch.eye(WG_SUB)[None, :, :, None]
    slow = _slow_chunks(log_w)
    state = torch.zeros((B, H, K, K))
    outs = []
    for c in range(n):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]
        cum = torch.cumsum(lwb, dim=1)                      # (B, L, H, K)
        cum_ex = cum - lwb
        o = prod("blhk,bhkv->blhv", rb * torch.exp(cum_ex), "rt", state,
                 "S")
        a = torch.zeros((B, L, L, H))
        for j in range(L // WG_SUB - 1):                     # below the diagonal
            cols = slice(WG_SUB * j, WG_SUB * (j + 1))
            rows = slice(WG_SUB * (j + 1), L)
            ref = cum[:, WG_SUB * (j + 1) - 1][:, None]     # c_j
            a[:, rows, cols] = prod(
                "bthk,bihk->btih", rb[:, rows] * torch.exp(cum_ex[:, rows]
                                                           - ref), "R",
                kb[:, cols] * torch.exp(ref - cum[:, cols]), "Kt")
        for p in range(L // WG_SUB):                         # the diagonal
            sl = slice(WG_SUB * p, WG_SUB * (p + 1))
            expo = cum_ex[:, sl, None] - cum[:, None, sl]
            expo = torch.where(tri[..., None], expo, float("-inf"))
            per_tid = (rb[:, sl, None] * kb[:, None, sl]
                       * torch.exp(expo)).sum(-1)
            ref = cum[:, WG_SUB * (p + 1) - 1][:, None]     # c_p
            products = prod(
                "bthk,bihk->btih", rb[:, sl] * torch.exp(cum_ex[:, sl] - ref),
                "R", kb[:, sl] * torch.exp(ref - cum[:, sl]), "Kt")
            a[:, sl, sl] = torch.where(
                slow[:, c, None, None], per_tid,
                torch.where(tri, products, 0.0)) \
                + eye * (rb[:, sl] * uf * kb[:, sl]).sum(-1)[:, :, None]
        outs.append(o + prod("btih,bihv->bthv", a, "A", vb, "v"))
        kdec = kb * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None] + prod(
            "bihk,bihv->bhkv", kdec, "kdec", vb, "v")
    out = torch.stack(outs, dim=1).reshape(B, n * L, H, K)[:, :S]
    return out if exact else out.to(r.dtype)


def _outside(got, want):
    """How many elements of ``got`` lie outside ``KERNEL_TOL[bf16]`` of
    ``want``."""
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    want = want.float()
    return int(((got.float() - want).abs() > atol + rtol * want.abs()).sum())


#: rwkv6-1.6b's prefill shape: B = 2 prompts of 2048 steps, 32 heads of 64
PREFILL = (2, 2048, 32, 64)


@pytest.mark.parametrize("decay", DECAYS + [-4.0])
def test_kernel_rounding_meets_the_kernel_bound(decay):
    """With the operands of ``SPLIT`` each split into bf16 hi + lo, the
    bf16 form's arithmetic stays within ``KERNEL_TOL[bf16]`` of the plain
    version in every element at the main path's shape: on the main path's
    decays and on log_w = -4 everywhere (a sub-chunk's cum falls 92 in log2
    units, near ``WG_RANGE``), each of which takes the products diagonal in
    every chunk."""
    args = _inputs(*PREFILL, dtype=torch.bfloat16, seed=11,
                   decay=decay if isinstance(decay, str) else "slow")
    if not isinstance(decay, str):
        args[3] = torch.full_like(args[3], decay)
    assert not _slow_chunks(args[3]).any()
    got = kernel_rounding(*args)
    want = wkv6_torch(*args)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("operand", SPLIT)
def test_rounding_one_operand_once_leaves_the_bound(operand):
    """Why the bf16 form splits each f32 operand: with that one rounded once
    to bf16 (the others split), outputs at the main path's shape fall
    outside ``KERNEL_TOL[bf16]`` of the plain version."""
    args = _inputs(*PREFILL, dtype=torch.bfloat16, seed=11, decay="slow")
    got = kernel_rounding(*args, split=tuple(o for o in SPLIT
                                             if o != operand))
    assert _outside(got, wkv6_torch(*args)) > 0


@pytest.mark.parametrize("log_w", [rwkv6.LOG_W_MIN, -30.0, -4.0],
                         ids=["LOG_W_MIN", "below-the-clamp", "near-the-range"])
def test_subchunk_factorisation_equals_the_plain_version(log_w):
    """The sub-chunk factorisation in f32, nothing rounded, is the plain
    version's arithmetic: within 1e-5, with every log_w at the model's
    clamp (a chunk's cum reaches -512) and below it (-30 a step: exp of a
    whole sub-chunk's cum underflows), where each full chunk's diagonal
    goes per (t, i, d); at -4 (92 in log2 units a sub-chunk, within
    ``WG_RANGE``: the diagonal as products with factors up to 2^92 and down
    to 2^-92).  Every exponent below the diagonal is <= 0, so nothing
    overflows, and nothing rests on the clamp."""
    r, k, v, _, u = _inputs(2, 200, 3, 64, seed=13)
    lw = torch.full_like(r, log_w)
    slow = _slow_chunks(lw)[:, :-1]            # the full chunks
    assert slow.all() if log_w < -4.0 else not slow.any()
    got = kernel_rounding(r, k, v, lw, u, exact=True)
    want = wkv6_torch(r, k, v, lw, u, chunk=WG_CHUNK)
    assert torch.isfinite(got).all()
    _close(got, want, 1e-5)


def test_kernel_rounding_takes_both_diagonals_in_one_call():
    """Mixed decays with head 0 at the model's clamp: the bf16 form forms
    head 0's diagonal sub-blocks per (t, i, d) and the other heads' as
    products in the same call, and its arithmetic stays within
    ``KERNEL_TOL[bf16]`` of the plain version."""
    args = _inputs(2, 512, 4, 64, dtype=torch.bfloat16, seed=15)
    args[3][:, :, 0] = rwkv6.LOG_W_MIN
    slow = _slow_chunks(args[3])
    assert slow[..., 0].all() and not slow[..., 1:].any()
    got = kernel_rounding(*args)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(),
                               wkv6_torch(*args).float().numpy(), atol=atol,
                               rtol=rtol)


def test_tma_readable_keeps_what_tma_reads_and_copies_the_rest():
    """The bf16 form's TMA reads tensors that start on 16 bytes with every
    stride but the last a multiple of 16 bytes: such a tensor (a view
    included) goes to the kernel as it is; one off 16 bytes, or a head of 12
    (rows of 24 bytes), is copied, contiguous and zero-padded to 16 bytes,
    with the same values in its first K columns."""
    n = 4 * 2 * 64
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    ok = base[:n].view(1, 4, 2, 64)
    assert ok.data_ptr() % 16 == 0 and ops._tma_readable(ok) is ok
    wide = torch.randn(1, 4, 2, 128).bfloat16()[..., :64]
    assert not wide.is_contiguous() and ops._tma_readable(wide) is wide
    shifted = base[1:1 + n].view(1, 4, 2, 64)
    shifted.copy_(torch.randn(1, 4, 2, 64))
    odd = torch.randn(1, 4, 2, 12).bfloat16()
    for t, width in ((shifted, 64), (odd, 16)):
        got = ops._tma_readable(t)
        assert got is not t and got.is_contiguous()
        assert got.shape[-1] == width and got.data_ptr() % 16 == 0
        assert torch.equal(got[..., :t.shape[-1]], t)
        assert not got[..., t.shape[-1]:].any()
    lw = torch.zeros(1, 4, 2, 12)                  # f32: 48-byte rows
    assert ops._tma_readable(lw) is lw


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rwkv6 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: (B, S, H, K): rwkv6-1.6b's prefill shape, B = 1, a ragged length, one
#: chunk and less, a small head, and the reference's sweep
CARD_SHAPES = [(2, 2048, 32, 64), (1, 2048, 32, 64), (2, 2000, 32, 64),
               (1, 32, 4, 64), (3, 37, 5, 16), (2, 200, 3, 16),
               (1, 70, 2, 48)] + [s[:4] for s in SWEEP]


@pytest.mark.cuda
@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "B{}-S{}-H{}-K{}".format(*s))
def test_kernel_matches_plain_version(card, shape, dtype, decay):
    args = _inputs(*shape, dtype=dtype, seed=11, device=card, decay=decay)
    before = ops.launches()
    got = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert ops.launches() == before + 1
    want = wkv6_torch(*args, chunk=ops.CHUNK)
    assert got.dtype == dtype and got.shape == args[0].shape
    atol, rtol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 48])
def test_kernel_reads_strided_views(card, K):
    """The model hands in r, k, v and log_w as (B, S, H, K) views of (B, S,
    d) projections; here views of one wider tensor, so no stride is the
    contiguous one (K = 48: rows of 96 bytes, every stride still on 16
    bytes, so the bf16 form reads them in place)."""
    B, S, H = 2, 100, 6
    _, _, _, log_w, u = _inputs(B, S, H, K, device=card, decay="slow")
    proj = torch.randn((B, S, 3 * H * K + 8), device=card).bfloat16()
    r, k, v = (t.reshape(B, S, H, K)
               for t in torch.split(proj[..., :3 * H * K], H * K, dim=-1))
    wide = torch.zeros((B, S, H, 2 * K), device=card)
    wide[..., :K] = log_w
    lw = wide[..., :K]
    assert not r.is_contiguous() and not lw.is_contiguous()
    assert all(ops._tma_readable(t) is t for t in (r, k, v, lw))
    got = ops.wkv6(r, k, v, lw, u)
    want = wkv6_torch(r.contiguous(), k.contiguous(), v.contiguous(),
                      lw.contiguous(), u, chunk=ops.CHUNK)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    args = _inputs(1, 16, 2, 128, device=card)
    with pytest.raises(ValueError, match="at most 64"):
        ops.wkv6(*args)
    r, k, v, log_w, u = _inputs(1, 16, 2, 8, device=card)
    with pytest.raises(ValueError, match="dtype"):
        ops.wkv6(r.double(), k.double(), v.double(), log_w, u)
    with pytest.raises(ValueError, match="dtype"):
        ops.wkv6(r, k.bfloat16(), v, log_w, u)
    with pytest.raises(ValueError, match="log_w"):
        ops.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), log_w.half(), u)
    strided = torch.randn((1, 16, 2, 16), device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last axis"):
        ops.wkv6(strided, k, v, log_w, u)
    with pytest.raises(ValueError, match="geometry"):
        ops.wkv6(r, k, v, log_w, u, geometry="n32")        # f32: none
    with pytest.raises(ValueError, match="geometry"):
        ops.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), log_w, u,
                 geometry="n128")


def _wkv_kernels_run(fn, attempts=3, calls=3):
    """The names of the WKV kernels (device kernels whose name holds
    "wkv6_kernel") that ``fn`` launches, under ``torch.profiler``.  After a
    few hundred profiles in one process (the card tests of all four kernels
    in one run), a profile of one short launch records no device event at
    all in about three of four tries on the H100, and one of ``calls``
    launches in none of the tries made; so each profile runs ``fn``
    ``calls`` times, and is taken again, up to ``attempts`` times, until it
    records a WKV kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = set()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()
                 if ev.device_type != DeviceType.CPU
                 and "wkv6_kernel" in ev.key}
        if names:
            break
    return names


def _assert_form(names, dtype):
    """bf16 runs the tensor-core form alone, f32 the CUDA-core form."""
    assert names, "no WKV kernel ran"
    if dtype == torch.bfloat16:
        assert all("wkv6_kernel_wgmma" in n for n in names), names
    else:
        assert not any("wgmma" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "B{}-S{}-H{}-K{}".format(*s))
def test_kernel_runs_the_form_of_its_dtype(card, shape, dtype):
    """bf16 runs ``wkv6_kernel_wgmma``, f32 ``wkv6_kernel``, by the names
    the profiler sees."""
    args = _inputs(*shape, dtype=dtype, seed=11, device=card, decay="slow")
    _assert_form(_wkv_kernels_run(lambda: ops.wkv6(*args)), dtype)


@pytest.mark.cuda
def test_bf16_kernel_copies_what_tma_cannot_read(card):
    """r at an offset off 16 bytes and a contiguous head of 12 (rows of 24
    bytes) break TMA's rules: the wrapper copies them, zero-padded, and
    still launches the tensor-core form, once."""
    r, k, v, log_w, u = _inputs(2, 130, 3, 12, dtype=torch.bfloat16,
                                device=card, decay="slow")
    shifted = torch.empty(r.numel() + 1, dtype=r.dtype, device=card)[1:]
    shifted = shifted.view(r.shape).copy_(r)
    assert shifted.data_ptr() % 16 and k.stride(2) * 2 % 16
    names = _wkv_kernels_run(lambda: ops.wkv6(shifted, k, v, log_w, u))
    _assert_form(names, torch.bfloat16)
    before = ops.launches()
    got = ops.wkv6(shifted, k, v, log_w, u)
    assert ops.launches() == before + 1
    want = wkv6_torch(r, k, v, log_w, u, chunk=ops.CHUNK)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sorted(ops.GEOMETRIES))
@pytest.mark.parametrize("log_w", ["slow", "mixed", rwkv6.LOG_W_MIN, -30.0],
                         ids=["slow", "mixed", "LOG_W_MIN", "below-the-clamp"])
def test_bf16_geometries_take_any_decay(card, geometry, log_w):
    """Every geometry of the bf16 form on decays whose sub-chunks fall
    within its range (the diagonal sub-blocks as products) and on log_w at
    the model's clamp and below it everywhere (a sub-chunk's cum falls past
    the range, so they are formed per (t, i, d)): within the kernel's bound,
    and finite."""
    decay = log_w if isinstance(log_w, str) else "slow"
    r, k, v, lw, u = _inputs(2, 300, 4, 64, dtype=torch.bfloat16, seed=14,
                             device=card, decay=decay)
    if not isinstance(log_w, str):
        lw = torch.full_like(lw, log_w)
    got = ops.wkv6(r, k, v, lw, u, geometry=geometry)
    want = wkv6_torch(r, k, v, lw, u, chunk=ops.CHUNK)
    assert torch.isfinite(got).all()
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_rwkv6_layer_launches_the_kernel_in_prefill_only(card):
    cfg = smoke_config("rwkv6-1.6b").scaled(dtype=torch.float32)
    from repro_torch.models.common import init_params
    p = init_params(torch.Generator(device=card).manual_seed(0), cfg,
                    card)["layers"][0]
    x = torch.randn((2, 70, cfg.d_model), device=card)
    zeros = torch.zeros((2, cfg.d_model), device=card)
    ops.reset_launches()
    got, _, _ = rwkv6.rwkv6_layer(x, zeros, zeros, p, cfg)
    torch.cuda.synchronize()
    assert ops.launches() == 1
    cpu_p = {k: v.cpu() for k, v in p.items()}
    want, _, _ = rwkv6.rwkv6_layer(x.cpu(), zeros.cpu(), zeros.cpu(), cpu_p,
                                   cfg)
    _close(got.cpu(), want, 2e-3)
    H, K = cfg.n_heads, cfg.d_model // cfg.n_heads
    rwkv6.rwkv6_decode_step(x[:, 0], zeros, zeros,
                            torch.zeros((2, H, K, K), device=card), p, cfg)
    assert ops.launches() == 1
