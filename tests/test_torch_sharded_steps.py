"""The port's sharded steps on 4 gloo CPU ranks against the reference's
unsharded step functions on the same inputs.

The reference's own sharded steps cannot run here (its activation
constraints fail on this jax's host mesh, ROADMAP Queue C), so each
sharded step of the port is held to the reference's *unsharded*
``prefill_fn`` / ``decode_fn`` / ``train_step_fn``.  One worker run of four
processes (this file run as a script, a gloo group of 4 ranks on a (2, 2)
``data,model`` mesh) drives the f32 smoke configs of qwen3-8b,
deepseek-moe-16b (grouped dispatch, 2 groups), zamba2-2.7b, rwkv6-1.6b,
hubert-xlarge and paligemma-3b through ``make_sharded_prefill``,
``make_sharded_decode`` (two steps) and, for every family and for the
dense one under pure FSDP with pinned gradients and whole-head attention,
``make_sharded_train_step`` with 2 microbatches; it also saves the
sharded parameters and restores them with ``shardings=``.  Rank 0 writes
the gathered results; the tests compare them within 2e-3.  A train step
is held by its gradients, not only by its parameters: on Adam's first step
each parameter moves by about lr whatever its gradient, so the gradient
norm and the AdamW moments are compared too, and a planted fault (the
dense step with every pending sum over the mesh dropped, so each rank
updates from its own part of the batch) must fail that comparison.  A
second run trains through ``launch.train --mesh 2,1`` on 2 ranks, and
resumes.  Every run has its own time limit.
"""
import dataclasses
import functools
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-8b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-1.6b",
         "hubert-xlarge", "paligemma-3b"]
DECODE_ARCHS = [a for a in ARCHS if a != "hubert-xlarge"]
#: train cases: (arch, config overrides), every family; the last pure
#: FSDP over (data, model), gradients pinned to the parameters' layouts,
#: whole-head q/k/v
TRAIN_CASES = {**{a: (a, {}) for a in ARCHS},
               "qwen3-8b-fsdp": ("qwen3-8b", dict(
                   shard_strategy="fsdp", grad_reduce="pinned",
                   attn_head_shard="heads"))}
#: planted faults: (the train case it is a fault of, how it is planted)
TRAIN_FAULTS = {"qwen3-8b-unreduced": "qwen3-8b"}
B, S, NEW = 4, 16, 2
TOL = 2e-3
#: each run's time limit, seconds
WORKER_LIMIT = 240


def _cfg(arch, **kw):
    from repro_torch.configs import smoke_config
    cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32, **kw)
    return dataclasses.replace(cfg, moe_groups=2) if cfg.family == "moe" \
        else cfg


def _batch(cfg, train=False):
    """The same numpy batch in every process."""
    rng = np.random.default_rng(7)
    if cfg.family == "hubert":
        out = {"features": rng.standard_normal((B, S, cfg.d_model),
                                               np.float32),
               "mask": rng.random((B, S)) < 0.3}
        if train:
            out["targets"] = rng.integers(0, cfg.vocab, (B, S), np.int32)
        return out
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S), np.int32)}
    if cfg.family == "paligemma":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model), np.float32)
    return out


def _params(cfg):
    from repro_torch.models.common import init_params
    return init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _unreduced(grads_fn, planted):
    """``train_step._grads`` with every pending sum over the mesh dropped:
    each rank keeps its own partial gradient as if it were the whole (a
    planted fault: gradients never reduced over ``data``).  Counts the
    gradients it changed in ``planted``."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.interop import map_lm_tree

    def drop(_p, _i, g):
        if not any(pl.is_partial() for pl in g.placements):
            return g
        planted[0] += 1
        return DTensor.from_local(
            g.to_local(), g.device_mesh,
            [Replicate() if pl.is_partial() else pl for pl in g.placements],
            run_check=False, shape=g.shape, stride=g.stride())

    def grads(*args):
        return map_lm_tree(grads_fn(*args), drop)
    return grads


def _worker(out_path: str, ckpt_dir: str) -> None:
    """One rank of the sharded run (the process group from the
    environment)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.interop import lm_leaves, lm_state_from_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import init_cache
    from repro_torch.serve.serve_step import (make_sharded_decode,
                                              make_sharded_prefill)
    from repro_torch.sharding.specs import distribute, full, to_shardings
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_train_state)

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    mesh = make_mesh((2, 2), ("data", "model"))
    results = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = _params(cfg)
        step, (p_specs, _) = make_sharded_prefill(cfg, mesh, B)
        results[arch, "prefill"] = step(params, _torch(_batch(cfg))
                                        ).full_tensor()
        if arch in DECODE_ARCHS:
            dstep, _ = make_sharded_decode(cfg, mesh, B)
            cache = init_cache(cfg, B, S, device="cpu")
            tok = _torch(_batch(cfg))["tokens"][:, :1]
            logits, toks = [], [tok]
            for _ in range(NEW):
                tok, lg, cache = dstep(params, cache, tok)
                logits.append(lg.full_tensor())
                toks.append(tok.full_tensor())
            results[arch, "decode"] = (torch.stack(logits),
                                       torch.cat(toks, 1))
        if arch == "qwen3-8b":
            shardings = to_shardings(p_specs, mesh)
            sharded = distribute(_params(cfg), shardings)
            save(ckpt_dir, 1, sharded)
            back, _ = restore(ckpt_dir, _params(cfg), shardings=shardings)
            same = all(
                torch.equal(a.to_local(), b.to_local())
                and a.placements == b.placements
                for (_, _, a), (_, _, b) in zip(lm_leaves(back),
                                                lm_leaves(sharded)))
            flags = torch.tensor([int(same)])
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            results["restore"] = bool(flags.item())
    import repro_torch.train.train_step as ts
    grads_fn = ts._grads
    for case, (arch, kw) in {**TRAIN_CASES, **{
            f: TRAIN_CASES[c] for f, c in TRAIN_FAULTS.items()}}.items():
        cfg = _cfg(arch, **kw)
        params = _params(cfg)
        opt = OptConfig(warmup_steps=1, total_steps=4)
        planted = [0]
        if case in TRAIN_FAULTS:
            ts._grads = _unreduced(grads_fn, planted)
        try:
            tstep, _ = make_sharded_train_step(cfg, opt, mesh, B, 2)
            p, st, m = tstep(params, make_train_state(cfg, opt, params),
                             _torch(_batch(cfg, train=True)))
        finally:
            ts._grads = grads_fn
        results[case, "train"] = {
            "loss": float(m["total_loss"]),
            "grad_norm": float(m["grad_norm"]),
            "params": lm_state_from_params(full(p)),
            "moments": full(st)["opt"]["state"], "planted": planted[0]}
    if rank == 0:
        torch.save(results, out_path)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n: int, argv, tmp: Path):
    """``n`` ranks of ``argv`` (after ``python``), a gloo group from the
    environment, started."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, *argv], cwd=tmp, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                 LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                 MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                 PYTHONPATH=str(ROOT / "src")))
        for rank in range(n)]


def _finish(procs):
    """Each rank's output, every rank ended with code 0 within the run's
    time limit (killed past it)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_LIMIT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


#: the launcher's flags but for ``--steps`` and ``--ckpt-dir``
TRAIN_ARGS = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch",
              "2", "--seq", "16", "--log-every", "1", "--ckpt-every", "1"]


def _train(steps: int, ckpt: Path):
    return ["-m", "repro_torch.launch.train", "--mesh", "2,1", "--steps",
            str(steps), *TRAIN_ARGS, "--ckpt-dir", str(ckpt)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded worker (4 ranks) and the launcher's first run (2 ranks,
    2 steps) side by side."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = tmp / "results.pt"
    worker = _start(4, [str(Path(__file__).resolve()), str(out),
                        str(tmp / "ckpt")], tmp)
    first = _start(2, _train(2, tmp / "launcher"), tmp)
    first_out = _finish(first)[0]
    _finish(worker)
    return {"results": torch.load(out, weights_only=False), "tmp": tmp,
            "first": first_out}


@pytest.fixture(scope="module")
def sharded(runs):
    return runs["results"]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's cfg and the port's weights in its layout."""
    import jax.numpy as jnp
    from repro.configs import smoke_config as ref_smoke_config
    from repro_torch.interop import lm_state_from_params
    cfg = _cfg(arch)
    rcfg = ref_smoke_config(arch).scaled(dtype=jnp.float32,
                                         moe_groups=cfg.moe_groups)
    state = lm_state_from_params(_params(cfg), cfg)
    import jax
    return rcfg, jax.tree.map(jnp.asarray, state)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_reference(sharded, arch):
    from repro.serve.serve_step import prefill_fn
    rcfg, rparams = _reference(arch)
    want = prefill_fn(rcfg)(rparams, _batch(rcfg))
    _close(sharded[arch, "prefill"], want)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_matches_reference(sharded, arch):
    """Two greedy steps from an empty cache: each step's logits within
    2e-3 and the same tokens."""
    import jax.numpy as jnp
    from repro.models.lm import init_cache
    from repro.serve.serve_step import decode_fn
    rcfg, rparams = _reference(arch)
    logits, toks = sharded[arch, "decode"]
    cache = init_cache(rcfg, B, S)
    tok = jnp.asarray(_batch(rcfg)["tokens"][:, :1])
    want_toks = [np.asarray(tok)]
    for i in range(NEW):
        tok, lg, cache = decode_fn(rcfg)(rparams, cache, tok)
        _close(logits[i], lg)
        want_toks.append(np.asarray(tok))
    np.testing.assert_array_equal(toks.numpy(),
                                  np.concatenate(want_toks, 1))


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    """The reference's unsharded step with 2 microbatches: (its metrics,
    the new parameters, the new AdamW state)."""
    from repro.train.optimizer import OptConfig as RefOptConfig
    from repro.train.train_step import make_train_state, train_step_fn
    rcfg, rparams = _reference(arch)
    opt = RefOptConfig(warmup_steps=1, total_steps=4)
    new, state, metrics = train_step_fn(rcfg, opt, 2)(
        rparams, make_train_state(rcfg, opt, rparams),
        _batch(rcfg, train=True))
    return metrics, new, state["opt"]["state"]


def _walk(tree):
    """(path, leaf) of a tree of nested dicts, in the reference's order."""
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(k.key for k in path), leaf


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_by_scale(got, want, what):
    """``got`` within 2e-3 of ``want`` relative to the largest |want|: a
    moment's elements range over decades, so an element-wise tolerance
    would either pass zeros or fail rounding."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale + 1e-30, (
        f"{what}: differs by {err:.3g}, {err / max(scale, 1e-30):.3g} of "
        f"its scale {scale:.3g}")


def _check_gradients(got, arch):
    """The gradient norm within 2e-3 and each AdamW moment (m, v: the
    step's clipped gradient and its square) within 2e-3 of its leaf's
    scale, against the reference's unsharded step."""
    metrics, _, moments = _reference_step(arch)
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]),
                               rtol=TOL, err_msg="grad_norm")
    n = 0
    for path, leaf in _walk(moments):
        _close_by_scale(_at(got["moments"], path), leaf, "/".join(path))
        n += 1
    assert n > 0


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_step_matches_reference(sharded, case):
    """One step with 2 microbatches: the loss and every updated parameter
    (the reference's layout) within 2e-3, and the gradients through the
    gradient norm and the AdamW moments (``_check_gradients``), which the
    parameters alone cannot show after one Adam step."""
    arch = TRAIN_CASES[case][0]
    metrics, new, _ = _reference_step(arch)
    got = sharded[case, "train"]
    _close(got["loss"], metrics["total_loss"])
    for path, leaf in _walk(new):
        _close(_at(got["params"], path), leaf)
    _check_gradients(got, arch)


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_sharded_train_step_check_catches_a_planted_fault(sharded, fault):
    """The dense step with its gradients left unreduced over the mesh
    (each rank updating from its own part of the batch): the gradient
    check must fail it."""
    got = sharded[fault, "train"]
    assert got["planted"] > 0, "no gradient had a pending sum to drop"
    with pytest.raises(AssertionError):
        _check_gradients(got, TRAIN_FAULTS[fault])


def test_restore_with_shardings_round_trips_bit_for_bit(sharded):
    """Sharded parameters saved (gathered, rank 0 writing) and restored
    with ``shardings=``: every rank's shards equal, placements too."""
    assert sharded["restore"] is True


def _losses(out: str):
    return [float(x) for x in re.findall(r"step\s+\d+\s+loss\s+([-\d.]+)",
                                         out)]


def test_train_launcher_on_a_mesh_trains_and_resumes(runs, tmp_path):
    """``launch.train --mesh 2,1`` on 2 ranks: 2 steps with a checkpoint
    each step, then a run to 4 steps resumes from step 2; its losses equal
    the unsharded launcher's in the same two runs within 2e-3 (the log
    prints 4 decimals)."""
    from repro_torch.launch.train import main
    second = _finish(_start(2, _train(4, runs["tmp"] / "launcher"),
                            runs["tmp"]))[0]
    got = _losses(runs["first"]) + _losses(second)
    want = []
    for steps in (2, 4):
        want += main([*TRAIN_ARGS, "--steps", str(steps), "--ckpt-dir",
                      str(tmp_path / "plain")])["losses"]
    assert len(got) == 4, got
    _close(got, want)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
