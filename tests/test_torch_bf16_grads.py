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
gradient plain autograd of the same forward would give.
"""
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

