"""Training traffic: the port's train step driven as ``launch/train.py``'s
loop drives it (``make_train_state``, ``train_step_fn``, each step's rows
uploaded, the loss read on the host at its end), on the harness's weights.

Set-up builds the one step object with its parameters and AdamW state and
drives it through the mix's first ``check_steps`` steps, which the
reference follows; the window continues the same object on new rows.
``correct`` compares each of those steps' loss, the first gradient as the
optimizer got it (its first moment after one step, over 1 - beta1) and
each parameter's change over the steps, leaf by leaf, with the reference's
(``reference/<family>.py``, ``reference/adamw.py``)."""
from __future__ import annotations

import math
import time

import torch

from portbench import mixes, weights
from portbench.kinds.common import (free, leaf_gap,
                                    program_config, program_weights,
                                    reference_weights)
from portbench.reference import adamw
from portbench.reference.common import full_f32, lm_loss
from portbench.trace import no_span, span

#: the numbers compared (each held to its limit where the cell's limits
#: file gives one)
NAMES = ("loss_gap", "grad_gap", "update_gap")


def _rows(ctx, step: int):
    mix = ctx.cell.traffic
    return mixes.train_rows(ctx.seed, step, mix["batch"], mix["seq_len"],
                            ctx.model["vocab"])


def _moment_norms(state, beta1: float, scale: float) -> dict:
    """The first gradient as the optimizer got it, by its first moment
    after one step: each optimizer leaf's norm of m over (1 - beta1) and
    over the clip ``scale`` the optimizer applied, by the leaf's path in
    the state (the reference's stacked layout)."""
    found = []

    def walk(node, path):
        if isinstance(node, dict):
            if isinstance(node.get("m"), torch.Tensor):
                found.append(("/".join(path), node["m"]))
                return
            for k, v in node.items():
                walk(v, path + (str(k),))
    walk(state["opt"]["state"], ())
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                         for _, t in found]).tolist()
    return {k: n / (1 - beta1) / scale for (k, _), n in zip(found, norms)}


def clip_scale(opt: dict, gnorm: float) -> float:
    """The factor the optimizer scaled the gradient by (its clip)."""
    return min(opt["grad_clip"] / (gnorm + 1e-9), 1.0)


def _change_norms(ctx, params, p0) -> dict:
    """Norm of each optimizer leaf's change from ``p0`` to ``params``."""
    sq: dict = {}
    parts = []
    for path, *_ in ctx.ref.leaves(ctx.model):
        d = weights.at(params, path).float() - weights.at(p0, path).float()
        parts.append((ctx.ref.stacked_key(path), d.square().sum()))
    vals = torch.stack([t for _, t in parts]).tolist()
    for (k, _), v in zip(parts, vals):
        sq[k] = sq.get(k, 0.0) + v
    return {k: math.sqrt(v) for k, v in sq.items()}


def _opt_config(ctx):
    from repro_torch.train.optimizer import OptConfig
    o = ctx.cell.traffic["optimizer"]
    return OptConfig(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                     weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                     warmup_steps=o["warmup_steps"],
                     total_steps=o["total_steps"])


def _one_step(ctx, prog, step: int, sp=no_span):
    """One step through the program: rows built and uploaded, the step,
    the loss read.  Returns (loss, host seconds of the rows); the step's
    metrics are left in ``prog["metrics"]``."""
    t0 = time.perf_counter()
    with sp("batch"):
        batch = {"tokens": torch.from_numpy(_rows(ctx, step)).to(ctx.device)}
    t1 = time.perf_counter()
    with sp("step"):
        params, state, metrics = prog["step"](prog["params"], prog["state"],
                                              batch)
    with sp("loss"):
        loss = float(metrics["total_loss"])
    prog["params"], prog["state"], prog["metrics"] = params, state, metrics
    return loss, t1 - t0


def setup(ctx):
    from repro_torch.train.train_step import make_train_state, train_step_fn
    cfg, opt = program_config(ctx), _opt_config(ctx)
    params = program_weights(ctx)
    step = train_step_fn(cfg, opt)
    if ctx.wrap is not None:
        step = ctx.wrap(step)
    prog = {"params": params, "step": step,
            "state": make_train_state(cfg, opt, params)}
    losses, grads = [], None
    for i in range(ctx.cell.traffic["check_steps"]):
        losses.append(_one_step(ctx, prog, i)[0])
        if i == 0:
            o = ctx.cell.traffic["optimizer"]
            grads = _moment_norms(prog["state"], opt.betas[0], clip_scale(
                o, float(prog["metrics"]["grad_norm"])))
    p0 = program_weights(ctx)
    changes = _change_norms(ctx, prog["params"], p0)
    del p0
    prog["readings"] = {"losses": losses, "grads": grads, "changes": changes}
    prog["next"] = len(losses)
    return prog


def _adamw_span():
    """Wrap the train step's optimizer call in the harness's ``adamw``
    span; returns the undo."""
    from repro_torch.train import train_step as ts
    inner = ts.adamw_update

    def spanned(*args, **kw):
        with span("adamw"):
            return inner(*args, **kw)
    ts.adamw_update = spanned

    def undo():
        ts.adamw_update = inner
    return undo


def window(ctx, prog, seconds: float, tracer):
    mix = ctx.cell.traffic
    tokens = mix["batch"] * mix["seq_len"]
    sp = span if tracer else no_span
    undo = _adamw_span() if tracer else None
    losses, host = [], []
    failed = n = 0
    step = prog["next"]
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracer:
                tracer.at(n, time.perf_counter() - t0)
            loss, hs = _one_step(ctx, prog, step, sp)
            if tracer:
                tracer.done(n, tokens=tokens)
            losses.append(loss)
            host.append(hs)
            failed += not math.isfinite(loss)
            step += 1
            n += 1
        wall = time.perf_counter() - t0
    finally:
        if undo:
            undo()
    return {"attempted": n, "failed": failed, "steps": n,
            "tokens": n * tokens, "wall_s": wall, "losses": losses,
            "batch_host_s": host, "units": [{"tokens": tokens}] * n}


def reference_readings(ctx, steps: int) -> dict:
    """The reference's losses of the first ``steps`` steps, its first
    gradient as its optimizer got it, and each leaf's change after them,
    with its gradient norms at the first step (for the leaf rule)."""
    o = dict(ctx.cell.traffic["optimizer"])
    ref, m = ctx.ref, ctx.model
    with full_f32():
        P, p0, stored = reference_weights(ctx)
        paths = [p for p, _ in stored]
        live = [weights.at(P, p) for p in paths]
        mom = [torch.zeros_like(t) for t in live]
        var = [torch.zeros_like(t) for t in live]
        losses, grads, gnorm = [], None, None
        for t in range(1, steps + 1):
            rows = torch.from_numpy(_rows(ctx, t - 1)).to(ctx.device).long()
            for x in live:
                x.requires_grad_(True)
            loss = lm_loss(ref.forward(P, m, rows[:, :-1]), rows[:, 1:])
            g = torch.autograd.grad(loss, live)
            losses.append(float(loss.detach()))
            for x in live:
                x.requires_grad_(False)
            total = adamw.step(live, g, mom, var, [d for _, d in stored], t,
                               o)
            if t == 1:
                grads = _keyed(ctx, paths, [
                    x / (1 - o["betas"][0]) / clip_scale(o, total)
                    for x in mom])
                gnorm = _keyed(ctx, paths, g)
            del g, loss
        changes = _change_norms(ctx, P, p0)
    del P, p0, live, mom, var
    free(ctx.device)
    return {"losses": losses, "grads": grads, "changes": changes,
            "grad_norms": gnorm}


def _keyed(ctx, paths, tensors) -> dict:
    sq: dict = {}
    vals = torch.stack([t.square().sum() for t in tensors]).tolist()
    for p, v in zip(paths, vals):
        k = ctx.ref.stacked_key(p)
        sq[k] = sq.get(k, 0.0) + v
    return {k: math.sqrt(v) for k, v in sq.items()}


def compare(got: dict, ref: dict) -> dict:
    """The three numbers compared, and the leaf each is worst at."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"]))
    grad, grad_leaf = leaf_gap(got["grads"], ref["grads"], ref["grad_norms"])
    upd, upd_leaf = leaf_gap(got["changes"], ref["changes"],
                             ref["grad_norms"])
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": upd,
            "worst": {"grad_gap": grad_leaf, "update_gap": upd_leaf}}


def verify(ctx, prog, record):
    got = prog.pop("readings")
    prog.clear()
    free(ctx.device)
    steps = len(got["losses"])
    ref = reference_readings(ctx, steps)
    nums = compare(got, ref)
    ctx.notes["readings"] = {"program": got["losses"],
                             "reference": ref["losses"],
                             "worst": nums["worst"]}
    if ctx.notes.get("control"):
        from portbench.reference.lowp import fp8_products
        with fp8_products():
            low = reference_readings(ctx, steps)
        ctx.notes["control"] = compare(low, ref)
    ctx.notes["numbers"] = {k: nums[k] for k in NAMES}
    lim = ctx.cell.limits
    return {k: {"value": nums[k], "limit": lim[k]} for k in NAMES
            if k in lim}
