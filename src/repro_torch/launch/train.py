"""End-to-end training entry point (the JAX package's ``launch/train.py``, in
PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --device cpu --steps 200 --batch 8 --seq 128 \
        --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 6 --batch 4 --seq 2048

Wires together the config registry -> the deterministic data pipeline
(host-sharded, restart-safe) -> the train step (microbatch accumulation,
optional int8 gradient compression, AdamW) -> checkpoints in the
reference's layout -> the fault-tolerant supervisor (straggler detection,
restart from the latest checkpoint).  The same flags as the reference's,
plus ``--device`` (default ``cuda``: the card; ``cpu`` trains the smoke
configs here).  Parameters come from ``init_params`` on a
``torch.Generator`` seeded with ``--seed``.  One device trains unsharded.
``--mesh d,m`` trains on a (data=d, model=m) mesh of d·m ranks, one
process a rank, through ``make_sharded_train_step``: the process group
comes from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; gloo on the CPU, nccl on cards, card
``LOCAL_RANK`` a rank) or from a caller that initialized it (a test's
spawn); with no group of d·m ranks the mesh is refused, naming the count.
Every rank draws the same parameters and the same global batch and keeps
its own shards; rank 0 writes the checkpoints and the log.  A model whose
parameters, gradients and AdamW state do not fit the card is refused
before any weight is made.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.interop import lm_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import init_params
from repro_torch.runtime.fault_tolerance import FaultConfig, Supervisor
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (make_sharded_train_step,
                                          make_train_state, train_step_fn)


def _fits(cfg, device, compress: bool) -> None:
    """Refuse a model whose parameters and gradients (in ``cfg.dtype``) and
    f32 AdamW moments (and error state) exceed the card's memory."""
    if device.type != "cuda":
        return
    item = torch.empty((), dtype=cfg.dtype).element_size()
    need = cfg.param_count() * (2 * item + 8 + (4 if compress else 0))
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise SystemExit(f"{cfg.name}: {need / 1e9:.1f} GB of parameters, "
                         f"gradients and optimizer state do not fit the "
                         f"card's {have / 1e9:.1f} GB; try --smoke")


def _join_group(n: int, device) -> int:
    """This process's rank in a process group of ``n`` ranks: the group a
    caller initialized, else one from ``torchrun``'s environment; refuses
    (``SystemExit``) any other rank count."""
    import torch.distributed as dist
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise SystemExit(f"--mesh of {n} devices needs a process group of "
                         f"{n} ranks (torchrun --nproc-per-node {n}); this "
                         f"process has {world}")
    return dist.get_rank()


def main(argv=None) -> dict:
    """Train; returns ``first_loss`` and ``last_loss`` (means of the first
    and last five steps' losses), ``params`` (the parameter count) and
    ``wall_s``, as the reference's launcher does, and besides them every
    step's ``losses`` and host seconds (``step_s``, each ending in a read
    of the loss, so the card has finished the step) and the final
    ``state`` ({"params", "opt"})."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--scale", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="error-feedback int8 gradient compression")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '4,2' for a (data=4, model=2) mesh")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.scale:
        cfg = dataclasses.replace(cfg, **json.loads(args.scale))
    opt = OptConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 20))
    device = torch.device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if len(shape) != 2:
            raise SystemExit(f"--mesh takes data,model; got {args.mesh!r}")
        if math.prod(shape) > 1:
            rank = _join_group(math.prod(shape), device)
            mesh = make_mesh(shape, ("data", "model"))
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ.get(
                    "LOCAL_RANK", rank)))
                torch.cuda.set_device(device)
    _fits(cfg, device, args.compress)
    dc = DataConfig(seed=args.seed, global_batch=args.batch,
                    seq_len=args.seq)
    if args.batch % max(1, args.microbatches):
        raise ValueError(f"batch {args.batch} does not split into "
                         f"{args.microbatches} microbatches")
    step_fn = (train_step_fn(cfg, opt, args.microbatches, args.compress)
               if mesh is None else make_sharded_train_step(
                   cfg, opt, mesh, args.batch, args.microbatches,
                   args.compress)[0])

    def make_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(gen, cfg, device)
        return {"params": params,
                "opt": make_train_state(cfg, opt, params, args.compress)}

    n_params = None
    losses, step_s = [], []

    def one_step(state, step_idx):
        nonlocal n_params
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 host_batch(cfg, dc, step_idx).items()}
        params, opt_state, metrics = step_fn(state["params"], state["opt"],
                                             batch)
        if n_params is None:
            n_params = sum(t.numel() for _, _, t in lm_leaves(params))
        loss = float(metrics["total_loss"])
        losses.append(loss)
        step_s.append(time.perf_counter() - t0)
        if step_idx % args.log_every == 0 and rank == 0:
            print(f"step {step_idx:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return {"params": params, "opt": opt_state}

    t0 = time.time()
    if args.ckpt_dir:
        sup = Supervisor(
            FaultConfig(ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every),
            make_state=make_state, step_fn=one_step)
        state = sup.run(args.steps)
    else:
        state = make_state()
        for i in range(args.steps):
            state = one_step(state, i)
    wall = time.time() - t0

    first = float(np.mean(losses[:5])) if losses else float("nan")
    last = float(np.mean(losses[-5:])) if losses else float("nan")
    if rank == 0:
        print(f"\narch={cfg.name} params={n_params:,} steps={args.steps} "
              f"wall={wall:.1f}s  loss {first:.3f} -> {last:.3f}")
    assert math.isfinite(last), "training diverged"
    return {"first_loss": first, "last_loss": last, "params": n_params,
            "wall_s": wall, "losses": losses, "step_s": step_s,
            "state": state}


if __name__ == "__main__":
    main()
