"""What the kinds' runners share: the program's configuration from the
cell's file, the weights on both sides, and the comparison numbers."""
from __future__ import annotations

import gc
import statistics

import torch

from portbench import weights


def program_config(ctx):
    """The port's ``ModelConfig`` from the configuration file's ``model``
    and ``family``."""
    from repro_torch.models.common import ModelConfig
    m = dict(ctx.model)
    dtype = getattr(torch, m.pop("dtype"))
    return ModelConfig(name=ctx.cell.config["name"],
                       family=ctx.cell.config["family"], dtype=dtype, **m)


def param_dtype(ctx):
    return getattr(torch, ctx.model["dtype"])


def program_weights(ctx):
    """The weights handed to the program."""
    return weights.build(ctx.ref.leaves(ctx.model), ctx.seed, ctx.device,
                         param_dtype(ctx))


def reference_weights(ctx):
    """(the f32 tree, the stored tree, [(path, stored dtype)]): the
    program's weights rebuilt from the seed, and their f32 copies."""
    leaves = ctx.ref.leaves(ctx.model)
    stored = weights.build(leaves, ctx.seed, ctx.device, param_dtype(ctx))
    f32: dict = {}
    for path, *_ in leaves:
        weights.put(f32, path, weights.at(stored, path).float())
    return f32, stored, [(lf[0], weights.at(stored, lf[0]).dtype)
                         for lf in leaves]


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def leaf_gap(prog: dict, ref: dict, ref_grad: dict):
    """The worst leaf's gap |prog - ref| / max(ref, median ref) over the
    leaves whose reference gradient norm is at least a thousandth of the
    median leaf's; (gap, leaf).  A leaf missing on the program's side
    reads 1e9."""
    if set(prog) != set(ref):
        return 1e9, f"leaves differ: {sorted(set(prog) ^ set(ref))[:6]}"
    med_g = statistics.median(ref_grad.values())
    kept = [k for k in ref if ref_grad[k] >= 1e-3 * med_g]
    med = statistics.median(ref[k] for k in kept)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
