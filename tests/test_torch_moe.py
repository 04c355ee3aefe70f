"""The port's MoE layers against the JAX package's.

On the same numpy inputs, the reference's functions (``repro.models.moe``)
and the port's: ``router_topk``'s indices equal, its weights and the aux
loss within 1e-6; ``moe_dispatch_combine`` with the keep mask equal to the
capacity rule applied to the reference's routing (each expert keeps its
first C (token, choice) pairs in flattened order) and the output within
2e-3 (f32) / 5e-2 (bf16), the tolerances of ``tests/test_kernels.py``, at a
capacity factor that drops tokens and at one that drops none; the grouped
form; ``moe_block`` with shared experts (deepseek-moe's smoke config), with
a dense residual (arctic's) and grouped.  All on the CPU, where the MoE is
plain tensor code on either side.

On a card (``cuda`` marker, skipped without one): one deepseek-moe-16b
layer's ``moe_block`` at its published widths on ``cuda`` against the same
call on the CPU.  That test imports nothing of JAX:

    python -m pytest -q -m cuda tests/test_torch_moe.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import moe

#: name -> (torch dtype, tolerance); the jax dtype is looked up lazily
DTYPES = {"f32": (torch.float32, 2e-3), "bf16": (torch.bfloat16, 5e-2)}


def _jax(a, dt):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a, np.float32)).astype(
        {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt])


def _torch(a, dt):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dt][0])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float(), np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _weights(rng, T, d, E, f):
    """x (T, d), the experts' (E, d, f) / (E, f, d) at the reference's
    initialisation scales, and the router (d, E) at 0.08, four times its
    initialisation's, so that a token's gates are far from uniform."""
    return (rng.standard_normal((T, d), np.float32),
            rng.standard_normal((E, d, f), np.float32) / np.sqrt(d),
            rng.standard_normal((E, d, f), np.float32) / np.sqrt(d),
            rng.standard_normal((E, f, d), np.float32) / np.sqrt(f),
            rng.standard_normal((d, E), np.float32) * 0.02 * 4)


def _capacity_keep(idx, E, C):
    """The capacity rule on routing ``idx`` (T, k), by a plain walk: each
    expert keeps its first C (token, choice) pairs in flattened order."""
    seen = np.zeros(E, np.int64)
    keep = np.zeros(idx.shape, bool)
    for t in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            keep[t, j] = seen[idx[t, j]] < C
            seen[idx[t, j]] += 1
    return keep


@pytest.mark.parametrize("E,k", [(8, 2), (64, 6), (128, 2)])
def test_router_topk_and_aux_match(E, k):
    import jax.numpy as jnp
    from repro.models import moe as rmoe
    logits = np.random.default_rng(E).standard_normal((200, E), np.float32)
    w, idx = moe.router_topk(torch.from_numpy(logits), k)
    rw, ridx = rmoe.router_topk(jnp.asarray(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)
    aux = moe.aux_load_balance_loss(torch.from_numpy(logits), idx, E)
    raux = rmoe.aux_load_balance_loss(jnp.asarray(logits), ridx, E)
    assert abs(float(aux) - float(raux)) <= 1e-6


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0],
                         ids=["dropping", "dropless"])
def test_dispatch_combine_matches(dt, act, capacity_factor):
    from repro.models import moe as rmoe
    T, d, E, f, k = 96, 32, 8, 16, 2
    x, wg, wu, wd, router = _weights(np.random.default_rng(7), T, d, E, f)
    kw = dict(top_k=k, capacity_factor=capacity_factor, act=act)
    out, aux = moe.moe_dispatch_combine(*(_torch(a, dt) for a in
                                          (x, wg, wu, wd)),
                                        torch.from_numpy(router), **kw)
    rout, raux = rmoe.moe_dispatch_combine(*(_jax(a, dt) for a in
                                             (x, wg, wu, wd)),
                                           _jax(router, "f32"), **kw)
    assert out.dtype == DTYPES[dt][0] and out.shape == (T, d)
    _close(out, rout, DTYPES[dt][1])
    assert abs(float(aux) - float(raux)) <= 1e-6
    # the keep mask: the capacity rule on the reference's own routing
    C = moe.expert_capacity(T, E, k, capacity_factor)
    r = moe.route(_torch(x, dt)[None], torch.from_numpy(router), k, C)
    xr = _jax(x, dt).astype("float32") @ _jax(router, "f32")
    _, ridx = rmoe.router_topk(xr, k)
    np.testing.assert_array_equal(r.idx[0].numpy(), np.asarray(ridx))
    want_keep = _capacity_keep(np.asarray(ridx), E, C)
    np.testing.assert_array_equal(r.keep[0].numpy(), want_keep)
    assert (not want_keep.all()) == (capacity_factor == 1.0)
    assert int(r.slot.min()) >= 0 and int(r.slot.max()) < E * C


@pytest.mark.parametrize("dt", DTYPES)
def test_dispatch_combine_fixed_capacity_matches(dt):
    from repro.models import moe as rmoe
    x, wg, wu, wd, router = _weights(np.random.default_rng(8), 40, 16, 4, 8)
    out, _ = moe.moe_dispatch_combine(*(_torch(a, dt) for a in
                                        (x, wg, wu, wd)),
                                      torch.from_numpy(router), top_k=2,
                                      capacity_factor=1.25, capacity=3)
    rout, _ = rmoe.moe_dispatch_combine(*(_jax(a, dt) for a in
                                          (x, wg, wu, wd)),
                                        _jax(router, "f32"), top_k=2,
                                        capacity_factor=1.25, capacity=3)
    _close(out, rout, DTYPES[dt][1])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0],
                         ids=["dropping", "dropless"])
def test_grouped_dispatch_matches(dt, groups, capacity_factor):
    from repro.models import moe as rmoe
    x, wg, wu, wd, router = _weights(np.random.default_rng(9), 64, 32, 8, 16)
    kw = dict(top_k=2, capacity_factor=capacity_factor, groups=groups)
    out, aux = moe.moe_dispatch_combine_grouped(
        *(_torch(a, dt) for a in (x, wg, wu, wd)), torch.from_numpy(router),
        **kw)
    rout, raux = rmoe.moe_dispatch_combine_grouped(
        *(_jax(a, dt) for a in (x, wg, wu, wd)), _jax(router, "f32"), **kw)
    _close(out, rout, DTYPES[dt][1])
    assert abs(float(aux) - float(raux)) <= 1e-6


def _block_params(rng, cfg, dt):
    """One layer's MoE weights as numpy, at the reference's scales."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    _, wg, wu, wd, router = _weights(rng, 1, d, E, f)
    p = {"router": router, "we_gate": wg, "we_up": wu, "we_down": wd}
    if cfg.n_shared_experts:
        S = cfg.n_shared_experts * f
        p["ws_gate"] = rng.standard_normal((d, S), np.float32) / np.sqrt(d)
        p["ws_up"] = rng.standard_normal((d, S), np.float32) / np.sqrt(d)
        p["ws_down"] = rng.standard_normal((S, d), np.float32) / np.sqrt(S)
    if cfg.dense_residual:
        p["dense"] = {
            n: rng.standard_normal(s, np.float32) / np.sqrt(s[0])
            for n, s in (("w_gate", (d, cfg.d_ff)), ("w_up", (d, cfg.d_ff)),
                         ("w_down", (cfg.d_ff, d)))}
    return p


def _convert(p, fn, dt):
    return {n: (_convert(v, fn, dt) if isinstance(v, dict) else
                fn(v, "f32" if n == "router" else dt)) for n, v in p.items()}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch,groups", [("deepseek-moe-16b", 1),
                                         ("arctic-480b", 1),
                                         ("deepseek-moe-16b", 2)],
                         ids=["shared", "dense-residual", "grouped"])
def test_moe_block_matches(dt, arch, groups):
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models import moe as rmoe
    cfg = dataclasses.replace(smoke_config(arch), moe_groups=groups,
                              capacity_factor=1.25)
    rcfg = dataclasses.replace(ref_smoke_config(arch), moe_groups=groups,
                               capacity_factor=1.25)
    rng = np.random.default_rng(10)
    p = _block_params(rng, cfg, dt)
    x = rng.standard_normal((2, 24, cfg.d_model), np.float32)
    out, aux = moe.moe_block(_torch(x, dt), _convert(p, _torch, dt), cfg)
    rout, raux = rmoe.moe_block(_jax(x, dt), _convert(p, _jax, dt), rcfg)
    assert out.shape == x.shape
    _close(out, rout, DTYPES[dt][1])
    assert abs(float(aux) - float(raux)) <= 1e-6


@pytest.mark.cuda
def test_deepseek_moe_block_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-moe-16b").scaled(dtype=torch.float32)
    rng = np.random.default_rng(11)
    p = _convert(_block_params(rng, cfg, "f32"), _torch, "f32")
    x = _torch(rng.standard_normal((2, 128, cfg.d_model), np.float32), "f32")
    dev = torch.device("cuda", 0)
    out, aux = moe.moe_block(x.to(dev),
                             {n: v.to(dev) for n, v in p.items()}, cfg)
    want, want_aux = moe.moe_block(x, p, cfg)
    C = moe.expert_capacity(256, cfg.n_experts, cfg.top_k,
                            cfg.capacity_factor)
    got_r = moe.route(x.to(dev).reshape(1, 256, -1), p["router"].to(dev),
                      cfg.top_k, C)
    want_r = moe.route(x.reshape(1, 256, -1), p["router"], cfg.top_k, C)
    assert torch.equal(got_r.idx.cpu(), want_r.idx)
    assert torch.equal(got_r.keep.cpu(), want_r.keep)
    assert not bool(want_r.keep.all())          # C drops at factor 1.25
    _close(out.cpu(), want.numpy(), 2e-3)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
