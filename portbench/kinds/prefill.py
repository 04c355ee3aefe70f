"""Prefill traffic: a closed loop with one request in flight.  Each request
is one prompt handed to the port's ``serve_step.prefill_fn`` as a (1, L)
batch; its reply is the last-position logits, copied to the host.  A
request's latency runs from its send (before the upload) to its logits on
the host.

Set-up runs every length of the mix's set once (the cell's shapes and no
others).  ``correct`` takes a sample of the requests the window answered,
drawn from the seed with the longest in it, runs the reference over each
prompt once the program is freed, and compares the served logits with the
reference's: their relative L2 distance (``logit_err``), and, read
beside it, the gap by which the served token's (the program's greedy
pick's) reference logit lies below the reference's best."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import mixes
from portbench.kinds.common import (free, program_config, program_weights,
                                    reference_weights)
from portbench.reference.common import full_f32
from portbench.trace import no_span, span

#: the numbers compared (each held to its limit where the cell's limits
#: file gives one)
NAMES = ("served_gap", "logit_err")


def _send(ctx, prog, tokens: np.ndarray):
    with torch.no_grad():
        out = prog["prefill"](prog["params"], {
            "tokens": torch.from_numpy(tokens).to(ctx.device)})
        return out.to("cpu")


def setup(ctx):
    from repro_torch.serve.serve_step import prefill_fn
    params = program_weights(ctx)
    prefill = prefill_fn(program_config(ctx))
    if ctx.wrap is not None:
        prefill = ctx.wrap(prefill)
    prog = {"params": params, "prefill": prefill}
    V = ctx.model["vocab"]
    lengths = mixes.prefill_lengths(ctx.cell.traffic)
    for i, L in enumerate(sorted(lengths, reverse=True)):
        _send(ctx, prog, mixes.warm_prompt(ctx.seed, i, L, V))
    return prog


def window(ctx, prog, seconds: float, tracer):
    mix, V = ctx.cell.traffic, ctx.model["vocab"]
    sp = span if tracer else no_span
    lat, lengths, replies = [], [], []
    failed = j = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        L = mixes.prefill_length(ctx.seed, j, mix)
        tokens = mixes.prefill_prompt(ctx.seed, j, L, V)
        if tracer:
            tracer.at(j, time.perf_counter() - t0)
        ts = time.perf_counter()
        with sp("request"):
            reply = _send(ctx, prog, tokens)
        te = time.perf_counter()
        if tracer:
            tracer.done(j, tokens=L)
        lat.append(te - ts)
        lengths.append(L)
        replies.append(reply[0])
        failed += not bool(torch.isfinite(reply.float()).all())
        j += 1
    wall = time.perf_counter() - t0
    return {"attempted": j, "failed": failed, "requests": j,
            "tokens": sum(lengths), "wall_s": wall, "latency_s": lat,
            "lengths": lengths, "replies": replies,
            "units": [{"tokens": L} for L in lengths]}


def sample(seed: int, lengths, n: int):
    """Indices of the requests checked: the longest (the first of them)
    and n - 1 others drawn from the seed."""
    longest = int(np.argmax(lengths))
    rest = [j for j in range(len(lengths)) if j != longest]
    rng = np.random.Generator(np.random.PCG64((seed, 3)))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[int(i)] for i in pick)


def reference_logits(ctx, picks, lengths):
    """The reference's last-position logits of each picked prompt."""
    V = ctx.model["vocab"]
    out = {}
    with full_f32(), torch.no_grad():
        P, stored, _ = reference_weights(ctx)
        del stored
        free(ctx.device)
        for j in picks:
            tok = torch.from_numpy(mixes.prefill_prompt(
                ctx.seed, j, lengths[j], V)).to(ctx.device)
            out[j] = ctx.ref.last_logits(P, ctx.model, tok)[0].float().cpu()
        del P
    free(ctx.device)
    return out


def compare(served: dict, ref: dict) -> dict:
    gap = err = 0.0
    for j, got in served.items():
        want = ref[j]
        tok = int(torch.argmax(got.float()))
        gap = max(gap, float(want.max() - want[tok]))
        err = max(err, float((got.float() - want).norm() / want.norm()))
    return {"served_gap": gap, "logit_err": err}


def verify(ctx, prog, record):
    picks = sample(ctx.seed, record["lengths"], ctx.cell.traffic["sample"])
    served = {j: record["replies"][j] for j in picks}
    prog.clear()
    free(ctx.device)
    ref = reference_logits(ctx, picks, record["lengths"])
    nums = compare(served, ref)
    ctx.notes["readings"] = {"picks": picks,
                             "lengths": [record["lengths"][j] for j in picks]}
    if ctx.notes.get("control"):
        from portbench.reference.lowp import fp8_products
        with fp8_products():
            low = reference_logits(ctx, picks, record["lengths"])
        ctx.notes["control"] = compare(low, ref)
    ctx.notes["numbers"] = {k: nums[k] for k in NAMES}
    lim = ctx.cell.limits
    return {k: {"value": nums[k], "limit": lim[k]} for k in NAMES
            if k in lim}
