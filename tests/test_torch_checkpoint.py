"""The port's checkpoints and training supervisor against the JAX
package's.

A checkpoint written by either package restores in the other, bit for bit:
a smoke model's train state (bf16 parameters, f32 AdamW moments and int8
error state, after two steps so that none is zero) saved by the port and
restored by the reference into its own template, and the other way round.
Both packages write the same leaf keys, shapes and dtype names.  Besides:
round trip and garbage collection, ``save_async``, restore onto a device,
and the ``Supervisor`` and ``StragglerMonitor`` tests of
``tests/test_distribution.py``.
"""
import json
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import host_batch as ref_host_batch
from repro.models.common import init_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.checkpoint.checkpoint import (latest_step, restore, save,
                                               save_async)
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.interop import lm_params_from_state, lm_state_from_params
from repro_torch.models.common import init_params
from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                 StragglerMonitor,
                                                 Supervisor, WorkerFailure)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_state, train_step_fn

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b", "rwkv6-1.6b", "deepseek-moe-16b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tests run many small ops; with several test processes on the
    machine, torch's intra-op threads only contend.  One thread for this
    module, the previous count restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(x) -> np.ndarray:
    """A leaf's bits: its values as f32 (bf16 holds exactly) viewed as
    uint32, so that -0.0 and 0.0 differ."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "f" or x.dtype.name == "bfloat16":
        return np.asarray(x, np.float32).view(np.uint32)
    return x


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_state(arch, steps=2, seed=3):
    """A bf16 smoke model's port train state after ``steps`` steps."""
    cfg = smoke_config(arch)
    opt = OptConfig(warmup_steps=1, total_steps=4)
    params = init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    state = {"params": params,
             "opt": make_train_state(cfg, opt, params, compress=True)}
    step = train_step_fn(cfg, opt, 1, compress=True)
    dc = DataConfig(global_batch=2, seq_len=8)
    for i in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in
                 host_batch(cfg, dc, i).items()}
        p, o, _ = step(state["params"], state["opt"], batch)
        state = {"params": p, "opt": o}
    return cfg, opt, state


def _ref_state(arch, steps=2):
    """The reference's train state after ``steps`` steps."""
    rcfg = ref_smoke_config(arch)
    ropt = ref_opt.OptConfig(warmup_steps=1, total_steps=4)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    state = {"params": params,
             "opt": ref_ts.make_train_state(rcfg, ropt, params, True)}
    step = ref_ts.train_step_fn(rcfg, ropt, 1, True)
    dc = RefDataConfig(global_batch=2, seq_len=8)
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in
                 ref_host_batch(rcfg, dc, i).items()}
        p, o, _ = step(state["params"], state["opt"], batch)
        state = {"params": p, "opt": o}
    return rcfg, ropt, state


def _as_ref_tree(state):
    """A port train state in the reference's layout, as numpy (bf16 as
    exact f32)."""
    out = {"params": lm_state_from_params(state["params"])}
    out["opt"] = jax.tree.map(lambda t: t.detach().float().numpy()
                              if t.is_floating_point() else t.numpy(),
                              state["opt"])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(arch):
    cfg, opt, state = _port_state(arch)
    rcfg = ref_smoke_config(arch)
    ropt = ref_opt.OptConfig(warmup_steps=1, total_steps=4)
    rparams = ref_init_params(jax.random.PRNGKey(1), rcfg)
    template = {"params": rparams,
                "opt": ref_ts.make_train_state(rcfg, ropt, rparams, True)}
    with tempfile.TemporaryDirectory() as d:
        save(d, 2, state, extra={"step": 2})
        restored, manifest = ref_ckpt.restore(d, template)
    assert manifest["extra"] == {"step": 2}
    got, want = _ref_leaves(restored), _ref_leaves(_as_ref_tree(state))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
    assert restored["params"]["embed"].dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch):
    rcfg, ropt, rstate = _ref_state(arch)
    cfg, opt, template = _port_state(arch, steps=0, seed=9)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(d, 2, rstate, extra={"step": 2})
        restored, manifest = restore(d, template)
    assert manifest["step"] == 2
    assert restored["params"]["embed"].dtype == torch.bfloat16
    got, want = _ref_leaves(_as_ref_tree(restored)), _ref_leaves(rstate)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)


def test_both_packages_write_the_same_manifest():
    """The same weights (crossed by interop) saved by each package: the
    same leaf keys, shapes and dtype names, and the same stored bits."""
    rcfg = ref_smoke_config("zamba2-2.7b")
    rparams = jax.tree.map(np.asarray,
                           ref_init_params(jax.random.PRNGKey(0), rcfg))
    params = lm_params_from_state(rparams, smoke_config("zamba2-2.7b"),
                                  "cpu")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref_ckpt.save(d1, 1, {"params": jax.tree.map(jnp.asarray, rparams)})
        save(d2, 1, {"params": params})
        m1, m2 = (json.loads((Path(d) / "step_00000001" / "manifest.json")
                             .read_text()) for d in (d1, d2))
        assert m1["leaves"] == m2["leaves"]
        a1 = np.load(Path(d1) / "step_00000001" / "arrays.npz")
        a2 = np.load(Path(d2) / "step_00000001" / "arrays.npz")
        assert sorted(a1.files) == sorted(a2.files)
        for k in a1.files:
            assert a1[k].dtype == a2[k].dtype, k
            np.testing.assert_array_equal(a1[k], a2[k], err_msg=k)


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "n": {"b": torch.ones(4, dtype=torch.bfloat16)},
                "step": torch.tensor(5, dtype=torch.int32)}
        for s in (10, 20, 30, 40):
            save(d, s, tree, keep=2)
        assert latest_step(d) == 40
        assert len(os.listdir(d)) == 2          # gc keeps 2
        template = {"a": torch.zeros(2, 3), "n": {"b": torch.zeros(
            4, dtype=torch.bfloat16)}, "step": torch.tensor(0,
                                                            dtype=torch.int32)}
        restored, manifest = restore(d, template)
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["n"]["b"], tree["n"]["b"])
        assert int(restored["step"]) == 5 and restored["step"].shape == ()
        assert manifest["step"] == 40
        with pytest.raises(FileNotFoundError):
            restore(os.path.join(d, "none"), template)


def test_save_async_and_restore_onto_a_device():
    with tempfile.TemporaryDirectory() as d:
        tree = {"w": torch.arange(8.0)}
        save_async(d, 1, tree).join()
        template = {"w": torch.zeros(8, dtype=torch.float64)}
        restored, _ = restore(d, template, device="cpu")
        assert restored["w"] is template["w"]          # filled in place
        assert torch.equal(restored["w"], tree["w"].double())
        with pytest.raises(ValueError, match="shape"):
            restore(d, {"w": torch.zeros(9)})
        with pytest.raises(KeyError, match="missing"):
            restore(d, {"v": torch.zeros(8)})


def test_supervisor_restart_resumes_deterministically():
    with tempfile.TemporaryDirectory() as d:
        def make_state():
            return {"x": torch.zeros(3)}

        def step_fn(state, step):
            return {"x": state["x"] + 1.0}

        cfg = FaultConfig(ckpt_dir=d, ckpt_every=2, max_restarts=3)
        crashed = {"done": False}

        def failure_hook(step):
            if step == 5 and not crashed["done"]:
                crashed["done"] = True
                return WorkerFailure(1, "injected node failure")
            return None

        remeshed = []
        sup = Supervisor(cfg, make_state=make_state, step_fn=step_fn,
                         on_remesh=remeshed.append)
        state = sup.run(8, failure_hook=failure_hook)
        assert sup.restarts == 1 and remeshed == [1]
        assert sup.events[0]["step"] == 5
        # restarted from step-4 checkpoint, continued to 8
        np.testing.assert_allclose(state["x"].numpy(), 8.0)


def test_supervisor_gives_up_after_max_restarts():
    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(FaultConfig(ckpt_dir=d, ckpt_every=1,
                                     max_restarts=2),
                         make_state=lambda: {"x": torch.zeros(1)},
                         step_fn=lambda s, i: s)
        with pytest.raises(WorkerFailure):
            sup.run(4, failure_hook=lambda s: WorkerFailure(0, "down"))
        assert sup.restarts == 3


def test_straggler_monitor_flags_persistent_laggard():
    m = StragglerMonitor(factor=2.0, strikes_to_fail=2)
    assert m.observe(0, 1.0) is None
    assert m.observe(0, 1.0) is None
    assert m.observe(0, 5.0) == "straggler"
    assert m.observe(0, 5.0) == "fail"
