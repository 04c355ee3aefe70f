"""The port's train stack against the JAX package's.

The reference's weights (``init_params(PRNGKey(0), cfg)``) cross into the
port through ``interop.lm_params_from_state``; the port's results come back
through ``lm_state_from_params``, in the reference's stacked layout, and
are compared leaf by leaf on the same numpy inputs (``host_batch``):
``lr_schedule``, ``adamw_update`` dense and factored on a smoke model's
stacked leaves (a per-layer norm is a factored ``(L, d)`` leaf whose
second moment couples the layers), ``compress_grads_int8`` bit for bit
(one scale per stacked leaf, round half to even), ``make_loss_and_grad``
with 1 and 2 microbatches and three steps of ``train_step_fn`` (plus
``compress=True``) for every family at smoke size in f32 within 2e-3 and
the dense family in bf16 within 5e-2, the tolerances of
``tests/test_kernels.py`` (ROADMAP Queue C: bf16 differs from itself under
``jit``; these reference runs are eager), and ``launch.train.main`` with a
restart against a loop of the reference's unsharded ``train_step_fn``
over the same batches (its own launcher fails on this jax, ROADMAP Queue
C).  The reference's own optimizer and compression tests are mirrored.
All of it runs on the CPU, where attention is the plain version.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import host_batch as ref_host_batch
from repro.models.common import init_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.interop import lm_params_from_state, lm_state_from_params
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, lr_schedule)
from repro_torch.train.train_step import (compress_grads_int8,
                                          make_loss_and_grad,
                                          make_sharded_train_step,
                                          make_train_state, train_step_fn)

#: one architecture of each family, and the model the card trains
FAMILY_ARCHS = ["h2o-danube-1.8b", "qwen3-8b", "deepseek-moe-16b",
                "rwkv6-1.6b", "zamba2-2.7b", "hubert-xlarge", "paligemma-3b"]
#: name -> (jax dtype, torch dtype, tolerance)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tests run many small ops; with several test processes on the
    machine, torch's intra-op threads only contend.  One thread for this
    module, the previous count restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dt):
    rcfg = ref_smoke_config(arch).scaled(dtype=DTYPES[dt][0])
    return rcfg, jax.tree.map(np.asarray,
                              ref_init_params(jax.random.PRNGKey(0), rcfg))


def _models(arch, dt):
    """(reference cfg, reference params, port cfg, port params) on the same
    weights; the port's are fresh tensors (the port updates in place)."""
    rcfg, rparams = _ref_params(arch, dt)
    pcfg = smoke_config(arch).scaled(dtype=DTYPES[dt][1])
    return (rcfg, jax.tree.map(jnp.asarray, rparams), pcfg,
            lm_params_from_state(rparams, pcfg, "cpu"))


def _batch(cfg, step=0, b=B, s=S):
    """The same host_batch for both packages: (jax dict, torch dict)."""
    arrs = host_batch(cfg, DataConfig(global_batch=b, seq_len=s), step)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _leaves(tree):
    """(key path, leaf) of a nested dict of arrays, sorted by path."""
    return [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close_trees(got, want, tol):
    """``got`` (a port tree, any layout ``lm_state_from_params`` takes) and
    ``want`` (a reference tree) hold the same leaves within ``tol``."""
    got = _leaves(lm_state_from_params(got))
    want = _leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=key)


def _state_np(state):
    """A port state tree (torch tensors, reference layout) as numpy."""
    return jax.tree.map(lambda t: t.float().numpy(), state)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(1, 50), (10, 100), (100, 10000)])
def test_lr_schedule_matches_reference(warmup, total):
    ref = ref_opt.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    opt = OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = np.array([0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                      total - 1, total, total + 7], np.int32)
    want = np.asarray(ref_opt.lr_schedule(ref, jnp.asarray(steps)))
    got = lr_schedule(opt, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _grads_like(rparams, seed):
    """Normal gradients in the reference layout, with a spread of scales."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-3, 0))
        .astype(np.float32), rparams)


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-2.7b", "rwkv6-1.6b"])
def test_adamw_update_matches_reference(arch, factored):
    """Three updates on a smoke model's stacked leaves, f32: the
    parameters and the state (step, m, v or v_row/v_col) in the
    reference's layout."""
    rcfg, rparams, pcfg, params = _models(arch, "f32")
    ropt = ref_opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                             factored=factored)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                    factored=factored)
    rstate = ref_opt.init_opt_state(rparams, ropt)
    state = init_opt_state(params, opt)
    for i in range(3):
        g = _grads_like(rparams, i)
        rparams, rstate, rm = ref_opt.adamw_update(
            rparams, jax.tree.map(jnp.asarray, g), rstate, ropt)
        params, state, m = adamw_update(
            params, lm_params_from_state(g, pcfg, "cpu"), state, opt)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(rstate["step"]) == 3
    _close_trees(params, rparams, 1e-5)
    got, want = _leaves(_state_np(state["state"])), _leaves(rstate["state"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-9,
                                   err_msg=key)


def test_factored_state_couples_the_layers_of_a_stacked_vector():
    """A per-layer norm (d,) is the reference's (L, d) leaf: factored into
    v_row (L,) and v_col (d,), shared by the layers."""
    _, _, pcfg, params = _models("qwen3-8b", "f32")
    st = init_opt_state(params, OptConfig(factored=True))["state"]
    L, d = pcfg.n_layers, pcfg.d_model
    assert set(st["norm1"]) == {"m", "v_row", "v_col"}
    assert st["norm1"]["v_row"].shape == (L,)
    assert st["norm1"]["v_col"].shape == (d,)
    assert st["attn"]["wq"]["v_row"].shape == (L, d)
    assert set(st["final_norm"]) == {"m", "v"}       # unstacked (d,)


def test_adamw_reduces_quadratic():
    opt = OptConfig(lr=0.1, warmup_steps=1, total_steps=100,
                    weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params, opt)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(params, grads, state, opt)
    assert float(params["w"].abs().max()) < 0.5


def test_factored_adam_matches_direction():
    opt = OptConfig(lr=0.01, factored=True, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.ones((8, 4))}
    state = init_opt_state(params, opt)
    assert "v_row" in state["state"]["w"] and "v" not in state["state"]["w"]
    before = params["w"].clone()
    params2, state, _ = adamw_update(params, {"w": torch.ones((8, 4))},
                                     state, opt)
    assert (params2["w"] < before).all()


def test_lr_schedule_warmup_and_decay():
    opt = OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert lr_schedule(opt, 5) < lr_schedule(opt, 10)
    assert lr_schedule(opt, 99) < lr_schedule(opt, 20)


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-2.7b"])
def test_compress_grads_int8_is_bit_exact(arch):
    """Two rounds of error feedback on a smoke model's gradients: the
    dequantized gradients and the error, bit for bit, one scale per
    stacked leaf (the per-layer slices alone would take other scales)."""
    rcfg, rparams, pcfg, params = _models(arch, "f32")
    rerr = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), rparams)
    err = make_train_state(pcfg, OptConfig(), params, compress=True)["err"]
    for i in range(2):
        g = _grads_like(rparams, 10 + i)
        rdeq, rerr = ref_ts.compress_grads_int8(
            jax.tree.map(jnp.asarray, g), rerr)
        deq, err = compress_grads_int8(
            lm_params_from_state(g, pcfg, "cpu"), err)
        for (key, a), (_, b) in zip(_leaves(lm_state_from_params(deq)),
                                    _leaves(rdeq)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
        for (key, a), (_, b) in zip(_leaves(_state_np(err)), _leaves(rerr)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)


def test_compression_error_feedback_bounds_bias():
    """Error feedback: quantization residual is carried, not dropped."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    err = {"w": torch.zeros(64)}
    acc = np.zeros(64, np.float32)
    true_acc = np.zeros(64, np.float32)
    for _ in range(50):
        deq, err = compress_grads_int8({"w": g}, err)
        acc += deq["w"].numpy()
        true_acc += g.numpy()
    assert np.abs(acc - true_acc).max() < 0.1


# ---------------------------------------------------------------------------
# loss, gradients and steps
# ---------------------------------------------------------------------------

#: every family in f32, and in bf16 the dense model the card trains,
#: qwen3-8b, whose embedding gradient showed that the port must round the
#: residual stream where the reference's compiled scan body does, and
#: hubert-xlarge, whose ``mask_embed`` gradient showed it for the encoder
#: block and for the activations' and norms' gradients (ROADMAP Queue C)
LOSS_CASES = ([(a, "f32") for a in FAMILY_ARCHS]
              + [("h2o-danube-1.8b", "bf16"), ("qwen3-8b", "bf16"),
                 ("hubert-xlarge", "bf16")])


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch,dt", LOSS_CASES,
                         ids=[f"{a}-{d}" for a, d in LOSS_CASES])
def test_loss_and_grad_match_reference(arch, dt, n_micro):
    rcfg, rparams, pcfg, params = _models(arch, dt)
    rbatch, batch = _batch(pcfg)
    tol = DTYPES[dt][2]
    rloss, rmetrics, rgrads = ref_ts.make_loss_and_grad(rcfg, n_micro)(
        rparams, rbatch)
    loss, metrics, grads = make_loss_and_grad(pcfg, n_micro)(params, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=tol, atol=tol)
    for k in ("loss", "zloss", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   rtol=tol, atol=tol)
    _close_trees(grads, rgrads, tol)
    assert all(not t.requires_grad for t in jax.tree.leaves(
        grads, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _outside(got, want, tol):
    """Leaf key -> the number of elements of ``got`` outside ``tol + tol
    |want|`` around ``want`` (two reference-layout trees)."""
    out = {}
    for (key, a), (_, b) in zip(_leaves(got), _leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        out[key] = int((np.abs(a - b) > tol + tol * np.abs(b)).sum())
    return out


#: elements of the first Mamba-2 input projection each scaled by 1 + 2^-7,
#: about one bf16 ulp, to measure how far the reference's own bf16
#: gradient moves (``tools/bf16_grad_sensitivity.py``'s three)
SPREAD_INDICES = (0, 1234, 5000)


@functools.lru_cache(maxsize=None)
def _reference_spread(arch, n_micro):
    """Leaf key -> the most elements of the reference's bf16 gradient that
    leave 5e-2 of it when one element of ``mamba.w_in`` moves by one ulp,
    over ``SPREAD_INDICES``."""
    rcfg, rparams = _ref_params(arch, "bf16")
    _, batch = _batch(smoke_config(arch).scaled(dtype=torch.bfloat16))
    rbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    grad = jax.jit(ref_ts.make_loss_and_grad(rcfg, n_micro))
    _, _, base = grad(jax.tree.map(jnp.asarray, rparams), rbatch)
    spread = {}
    for index in SPREAD_INDICES:
        bumped = jax.tree.map(np.array, rparams)
        w = bumped["mamba"]["w_in"].reshape(-1)
        w[index] = (w[index].astype(np.float32)
                    * (1 + 2.0 ** -7)).astype(w.dtype)
        _, _, moved = grad(jax.tree.map(jnp.asarray, bumped), rbatch)
        for key, n in _outside(moved, base, DTYPES["bf16"][2]).items():
            spread[key] = max(spread.get(key, 0), n)
    return spread


@pytest.mark.parametrize("n_micro", [1, 2])
def test_zamba2_bf16_gradient_within_reference_spread(n_micro):
    """zamba2-2.7b in bf16 (ROADMAP Queue C, C1, open): the loss and every
    gradient leaf but ``embed`` within 5e-2 of the reference's; ``embed``
    has no more elements outside 5e-2 than the reference's own gradient
    moves past it under a one-ulp change of one weight.  The port's f32
    arithmetic differs from XLA's in the last bit (a bf16 product's
    accumulation order, softplus's libm), which flips a few bf16 roundings
    in the first Mamba-2 layer that the layers after it spread into the
    embedding's gradient."""
    rcfg, rparams, pcfg, params = _models("zamba2-2.7b", "bf16")
    rbatch, batch = _batch(pcfg)
    tol = DTYPES["bf16"][2]
    rloss, _, rgrads = ref_ts.make_loss_and_grad(rcfg, n_micro)(rparams,
                                                                rbatch)
    loss, _, grads = make_loss_and_grad(pcfg, n_micro)(params, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=tol, atol=tol)
    outside = _outside(lm_state_from_params(grads), rgrads, tol)
    spread = _reference_spread("zamba2-2.7b", n_micro)
    assert outside.pop("['embed']") <= spread["['embed']"]
    assert not any(outside.values()), outside


def test_microbatch_accumulation_matches_full_batch():
    _, _, cfg, params = _models("h2o-danube-1.8b", "bf16")
    _, batch = _batch(cfg)
    loss1, _, grads1 = make_loss_and_grad(cfg, 1)(params, batch)
    loss2, _, grads2 = make_loss_and_grad(cfg, 2)(params, batch)
    assert abs(float(loss1) - float(loss2)) < 5e-3
    for (_, a), (_, b) in zip(_leaves(lm_state_from_params(grads1)),
                              _leaves(lm_state_from_params(grads2))):
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=5e-2)


STEP_CASES = ([(a, "f32", False) for a in FAMILY_ARCHS]
              + [("qwen3-8b", "f32", True), ("zamba2-2.7b", "f32", True),
                 ("h2o-danube-1.8b", "bf16", False),
                 ("h2o-danube-1.8b", "bf16", True)])


@pytest.mark.parametrize("arch,dt,compress", STEP_CASES,
                         ids=[f"{a}-{d}{'-int8' if c else ''}"
                              for a, d, c in STEP_CASES])
def test_train_steps_match_reference(arch, dt, compress):
    """Three steps of ``train_step_fn`` on three host batches: every
    step's loss, gradient norm and learning rate, then the parameters and
    the AdamW moments."""
    rcfg, rparams, pcfg, params = _models(arch, dt)
    tol = DTYPES[dt][2]
    ropt = ref_opt.OptConfig(warmup_steps=1, total_steps=3)
    opt = OptConfig(warmup_steps=1, total_steps=3)
    rstep = ref_ts.train_step_fn(rcfg, ropt, 1, compress)
    step = train_step_fn(pcfg, opt, 1, compress)
    rstate = ref_ts.make_train_state(rcfg, ropt, rparams, compress)
    state = make_train_state(pcfg, opt, params, compress)
    assert set(state) == set(rstate)
    for i in range(3):
        rbatch, batch = _batch(pcfg, step=i)
        rparams, rstate, rm = rstep(rparams, rstate, rbatch)
        params, state, m = step(params, state, batch)
        for k in ("total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=tol,
                                       atol=tol, err_msg=k)
    _close_trees(params, rparams, tol)
    got = _leaves(_state_np(state["opt"]["state"]))
    want = _leaves(rstate["opt"]["state"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=key)


def test_sharded_train_step_runs_on_one_device_and_refuses_more():
    _, _, cfg, params = _models("h2o-danube-1.8b", "f32")
    opt = OptConfig(warmup_steps=1, total_steps=2)
    step, specs = make_sharded_train_step(cfg, opt, make_host_mesh("cpu", 1),
                                          B)
    assert specs == (None, None, None)
    _, batch = _batch(cfg)
    _, state, m = step(params, make_train_state(cfg, opt, params), batch)
    assert np.isfinite(float(m["total_loss"]))
    # more devices take a named mesh (launch.mesh.make_mesh), not a list
    with pytest.raises(ValueError, match="named mesh"):
        make_sharded_train_step(cfg, opt, make_host_mesh("cpu", 2), B)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _ref_loop(arch, steps_by_run, batch, seq, seed):
    """The reference's unsharded ``train_step_fn`` over the launcher's
    batches, from the port's initial weights: each run's steps under that
    run's OptConfig, as the launcher builds it."""
    from repro_torch.models.common import init_params
    pcfg = smoke_config(arch)
    rcfg = ref_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(seed), pcfg, "cpu")
    rparams = jax.tree.map(lambda a: jnp.asarray(a).astype(rcfg.dtype),
                           lm_state_from_params(params, pcfg))
    losses, state, done = [], None, 0
    dc = RefDataConfig(seed=seed, global_batch=batch, seq_len=seq)
    for n in steps_by_run:
        ropt = ref_opt.OptConfig(lr=3e-4, total_steps=n,
                                 warmup_steps=max(1, n // 20))
        step = ref_ts.train_step_fn(rcfg, ropt)
        if state is None:
            state = ref_ts.make_train_state(rcfg, ropt, rparams)
        for i in range(done, n):
            b = {k: jnp.asarray(v) for k, v in
                 ref_host_batch(rcfg, dc, i).items()}
            rparams, state, m = step(rparams, state, b)
            losses.append(float(m["total_loss"]))
        done = n
    return losses


def test_train_launcher_with_restart_matches_reference_loop(capsys):
    from repro_torch.launch.train import main
    arch, seq, batch = "h2o-danube-1.8b", 32, 2
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch",
            str(batch), "--seq", str(seq), "--log-every", "1"]
    with tempfile.TemporaryDirectory() as d:
        out1 = main(args + ["--steps", "6", "--ckpt-dir", d,
                            "--ckpt-every", "3"])
        # resume: the supervisor restores step 6 and runs to 8
        out2 = main(args + ["--steps", "8", "--ckpt-dir", d,
                            "--ckpt-every", "4"])
    assert len(out1["losses"]) == 6 and len(out2["losses"]) == 2
    assert np.isfinite(out1["last_loss"]) and np.isfinite(out2["last_loss"])
    assert out1["params"] == out2["params"] == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(
            _ref_params(arch, "bf16")[1]))
    printed = capsys.readouterr().out
    assert printed.count("step ") >= 8 and "loss" in printed
    want = _ref_loop(arch, (6, 8), batch, seq, 0)
    np.testing.assert_allclose(out1["losses"] + out2["losses"], want,
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(out1["first_loss"], np.mean(want[:5]),
                               rtol=5e-2, atol=5e-2)


def test_train_launcher_refuses_a_mesh_of_more_devices():
    from repro_torch.launch.train import main
    # a 2-device mesh needs a process group of 2 ranks; this process has none
    with pytest.raises(SystemExit, match="2 ranks"):
        main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
              "--steps", "1", "--batch", "2", "--seq", "8", "--mesh", "2,1"])
