"""bf16 gradients of the port's model pieces against the JAX package's, bit
for bit.

In bf16 the reference's gradient rounds after each step of its autodiff,
and the port's pieces round at the same steps: ``layers.silu`` and
``layers.gelu`` (written-out forwards whose gradients follow the
reference's derivative rules, ``logistic``'s ans (1 - ans) and ``tanh``'s
(g + g ans)(1 - ans)), ``layers.rms_norm`` (x read through two casts, as
the reference's ``rms_norm`` writes it, so x's gradient gets two roundings;
the scale's, a sum over the rows in f32, is held within one bf16 ulp).
Each is held to ``jax.vjp`` of the reference's
function on the same numpy inputs, eagerly and inside ``lax.scan`` (the
compiled layer body the models run), and shown to differ from the
gradient plain autograd of the same forward would give.  zamba2's first
Mamba-2 layer is held to the reference's point by point: with the
reference's values injected at the four points whose arithmetic torch
cannot match bit for bit (the input projection, softplus, the SSD scan's
f32 sums, the output projection), its outputs equal the reference's, and
with only some injected, the rest differ (ROADMAP Queue C, C1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.models import layers


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one torch thread for this module, the previous
    count restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _draw(shape, scale=1.0, seed=0):
    """A bf16 draw as (jax array, torch tensor) holding the same values."""
    a = (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _ref_vjp(fn, args, ct, scan: bool):
    """The reference's output and input gradients of ``fn`` at ``args``
    for the cotangent ``ct``, eagerly or as the body of a one-step
    ``lax.scan``."""
    def vjp(*a):
        out, pull = jax.vjp(fn, *a)
        return (out, *pull(ct))
    if not scan:
        return [np.asarray(v, np.float32) for v in vjp(*args)]

    def body(carry, xs):
        return carry, vjp(*xs)
    _, outs = jax.lax.scan(body, 0, tuple(a[None] for a in args))
    return [np.asarray(v[0], np.float32) for v in outs]


def _bits(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("scan", [False, True], ids=["eager", "scan"])
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_gradient_matches_the_reference_bit_for_bit(name, scan):
    xj, xt = _draw((64, 256), 2.0, seed=1)
    gj, gt = _draw((64, 256), 1.0, seed=2)
    ref_fn = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[name]
    port_fn = getattr(layers, name)
    want_out, want_grad = _ref_vjp(ref_fn, (xj,), gj, scan)
    x = xt.clone().requires_grad_(True)
    out = port_fn(x)
    (grad,) = torch.autograd.grad(out, x, gt)
    np.testing.assert_array_equal(_bits(out), want_out)
    np.testing.assert_array_equal(_bits(grad), want_grad)
    # autograd of the same written-out steps rounds elsewhere
    x = xt.clone().requires_grad_(True)
    if name == "silu":
        plain = x * layers.sigmoid(x)
    else:
        c1, c2 = (float(torch.tensor(c, dtype=torch.bfloat16))
                  for c in (0.044715, (2.0 / np.pi) ** 0.5))
        plain = x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))
    (plain_grad,) = torch.autograd.grad(plain, x, gt)
    assert (_bits(plain_grad) != want_grad).mean() > 0.05


def test_rms_norm_gradient_matches_the_reference_bit_for_bit():
    xj, xt = _draw((4, 16, 256), 2.0, seed=3)
    sj, st = _draw((256,), 0.1, seed=4)
    gj, gt = _draw((4, 16, 256), 1.0, seed=5)
    want = _ref_vjp(ref_layers.rms_norm, (xj, sj), gj, scan=True)
    x, s = (t.clone().requires_grad_(True) for t in (xt, st))
    out = layers.rms_norm(x, s)
    got = [out, *torch.autograd.grad(out, (x, s), gt)]
    for name, g, w in zip(("out", "dx"), got, want):
        np.testing.assert_array_equal(_bits(g), w, err_msg=name)
    # dscale sums 64 rows in f32 before its rounding, in another order
    # than XLA's: within one bf16 ulp
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[2]) + 1e-30)) - 7)
    assert (np.abs(_bits(got[2]) - want[2]) <= ulp).all()
    # one cast of x: its two gradient terms summed in f32, rounded once
    x = xt.clone().requires_grad_(True)
    xf = x.float()
    one = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
           * (1.0 + st.float())).to(x.dtype)
    (dx_once,) = torch.autograd.grad(one, x, gt)
    assert (_bits(dx_once) != want[1]).any()



# ---------------------------------------------------------------------------
# zamba2's first Mamba-2 layer, point by point (ROADMAP Queue C, C1)
# ---------------------------------------------------------------------------

class _Taken:
    """A weight whose product ``h @ w`` returns a value given beforehand
    (``put``) or records the product it stands for (``take``): a value
    injected at a projection's output, or read there, with nothing in
    either package changed."""

    def __init__(self, w, put=None):
        self.w, self.put, self.took, self.operand = w, put, None, None

    def __rmatmul__(self, h):
        self.operand = h
        if self.put is not None:
            return self.put
        self.took = h @ self.w
        return self.took


@functools.lru_cache(maxsize=None)
def _zamba2_first_layer():
    """zamba2's smoke model in bf16 on the reference's ``init_params``
    (``tests/test_torch_train.py``'s model): the first Mamba-2 layer's
    weights, its input (the embedded inputs of ``host_batch`` 4 x 16 at step
    0), and the reference's values at the layer's four points, read from
    its own run: the input projection's output ``z``, softplus's ``dt``, the
    SSD scan's ``y`` and the output projection's ``proj``."""
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models import mamba2 as ref_mamba2
    from repro.models.common import init_params
    from repro.models.lm import _embed
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch

    rcfg = ref_smoke_config("zamba2-2.7b").scaled(dtype=jnp.bfloat16)
    rparams = init_params(jax.random.PRNGKey(0), rcfg)
    pcfg = smoke_config("zamba2-2.7b").scaled(dtype=torch.bfloat16)
    tokens = host_batch(pcfg, DataConfig(global_batch=4, seq_len=16),
                        0)["tokens"][:, :-1]
    x = _embed(rparams, rcfg, jnp.asarray(tokens))
    lp = jax.tree.map(lambda w: w[0], rparams["mamba"])
    w_in, w_out = _Taken(lp["w_in"]), _Taken(lp["w_out"])
    seen = {}
    softplus, ssd = jax.nn.softplus, ref_mamba2.ssd_chunked

    def take(name, fn):
        def run(*a, **k):
            seen[name + "_in"] = a
            seen[name] = fn(*a, **k)
            return seen[name]
        return run
    jax.nn.softplus = take("dt", softplus)
    ref_mamba2.ssd_chunked = take("y", ssd)
    try:
        out, conv, _ = ref_mamba2.mamba2_layer(
            x, dict(lp, w_in=w_in, w_out=w_out), rcfg)
    finally:
        jax.nn.softplus, ref_mamba2.ssd_chunked = softplus, ssd
    seen.update(z=w_in.took, proj=w_out.took, proj_in=w_out.operand,
                out=out, conv=conv)

    def port(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.bfloat16() if a.dtype == jnp.bfloat16 else t
    def port_all(v):
        return tuple(map(port, v)) if isinstance(v, tuple) else port(v)
    return (pcfg, port(x), {k: port(v) for k, v in lp.items()},
            {k: port_all(v) for k, v in seen.items()})


def _port_first_layer(put, seen):
    """The port's first Mamba-2 layer on the reference's input with the
    reference's values injected at the points named in ``put``; what it
    computes at each of the four points, and its outputs."""
    from repro_torch.models import mamba2
    pcfg, x, p, ref = _zamba2_first_layer()
    w_in = _Taken(p["w_in"], ref["z"] if "z" in put else None)
    w_out = _Taken(p["w_out"], ref["proj"] if "proj" in put else None)
    softplus, ssd = mamba2.F.softplus, mamba2.ssd

    def at(name, fn):
        def run(*a):
            seen[name + "_in"] = a
            seen[name] = ref[name] if name in put else fn(*a)
            return seen[name]
        return run
    mamba2.F.softplus = at("dt", softplus)
    mamba2.ssd = at("y", ssd)
    try:
        out, conv, _ = mamba2.mamba2_layer(
            x, dict(p, w_in=w_in, w_out=w_out), pcfg)
    finally:
        mamba2.F.softplus, mamba2.ssd = softplus, ssd
    seen.update(z=w_in.took if w_in.took is not None else ref["z"],
                proj=w_out.took if w_out.took is not None else ref["proj"],
                proj_in=w_out.operand, out=out, conv=conv)
    return ref


def _differ(a, b):
    """Elements where two tensors' values differ."""
    return int((_bits(a) != _bits(b)).sum())


def test_zamba2_first_mamba_layer_differs_only_where_roundings_do():
    """C1, zamba2's part: the port's first Mamba-2 layer in bf16 against the
    reference's, point by point, in its forward.  With the reference's
    input-projection and softplus outputs injected, everything between the
    points is bit-equal (the split, the conv and its silu: the SSD scan's
    six inputs; the gate's norm and silu: the output projection's operand
    once y is the reference's), but two more points still differ: the SSD
    scan's y (its f32 sums in another order than XLA's scan, which flips a
    bf16 rounding) and the output projection (torch's bf16 CPU product
    accumulates in another order than XLA's dot).  With all four injected
    the layer's outputs are bit-equal.  So the layer's forward differs from
    the reference's at these four roundings and no other step."""
    seen = {}
    ref = _port_first_layer({"z", "dt"}, seen)
    # the scan's six inputs (the split, the conv and its silu) and the
    # conv state: bit-equal
    assert len(seen["y_in"]) == len(ref["y_in"]) == 6
    for i, (got, want) in enumerate(zip(seen["y_in"], ref["y_in"])):
        assert _differ(got, want) == 0, f"ssd input {i}"
    assert _differ(seen["conv"], ref["conv"]) == 0
    # y: a few elements, at most one bf16 ulp apart
    moved = _differ(seen["y"], ref["y"])
    assert 0 < moved <= 4, moved
    ulp = 2.0 ** (np.floor(np.log2(np.abs(_bits(ref["y"])) + 1e-30)) - 7)
    assert (np.abs(_bits(seen["y"]) - _bits(ref["y"])) <= ulp).all()
    # with y injected too: the output projection's operand (the gate's
    # norm and silu) is bit-equal, its product still differs
    seen = {}
    _port_first_layer({"z", "dt", "y"}, seen)
    assert _differ(seen["proj_in"], ref["proj_in"]) == 0
    moved = _differ(seen["proj"], ref["proj"])
    assert 0 < moved <= 4, moved
    # all four injected: the outputs are the reference's, bit for bit
    seen = {}
    _port_first_layer({"z", "dt", "y", "proj"}, seen)
    for name in ("out", "conv"):
        assert _differ(seen[name], ref[name]) == 0, name


@pytest.mark.parametrize("point", ["z", "dt"])
def test_zamba2_first_mamba_layer_named_points_differ_on_their_own(point):
    """The input projection and softplus, computed by the port on the
    reference's own operands, differ from the reference's values: neither
    can be matched bit for bit from torch (the product's accumulation
    order; XLA's f32 ``logaddexp`` against ``F.softplus``)."""
    seen = {}
    ref = _port_first_layer({"z", "dt"} - {point}, seen)
    assert _differ(seen[point], ref[point]) > 0
