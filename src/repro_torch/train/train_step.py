"""The train step with microbatch gradient accumulation (the JAX package's
``train/train_step.py``, in PyTorch).

Gradients come from ``torch.autograd.grad`` of ``lm_loss`` with respect to
detached aliases of the parameters that require grad (the caller's tensors
are not changed; with grad on a parameter, ``models.lm`` rematerializes each
layer, and attention's gradient on the card is the backward kernel).  The
reference's ``lax.scan`` over microbatches is a loop with an f32
accumulator.  Optional error-feedback int8 gradient compression takes one
scale per reference leaf, over the whole ``(L, ...)`` stack, with the error
state kept in the reference's layout (``optimizer.stacked_zeros``).

``make_sharded_train_step`` lays parameters, optimizer state and batch out
by ``sharding.specs`` as ``DTensor``s over a named mesh
(``launch.mesh.make_mesh``) and runs this step under the activation rules;
with ``grad_reduce == "pinned"`` the gradients are laid out as their
parameters before the optimizer reads them.  A one-device list
(``launch.mesh.make_host_mesh``) gives the plain step.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.interop import at_path, lm_groups, lm_leaves, map_lm_tree
from repro_torch.launch.input_specs import param_structs
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import whole_over
from repro_torch.models.lm import lm_loss
from repro_torch.sharding.ctx import like, make_rules, sharded
from repro_torch.sharding.specs import (batch_sharded, batch_specs,
                                        distribute, full,
                                        param_specs, sanitize_specs,
                                        to_shardings)
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, opt_state_specs,
                                         stacked_zeros)


def compress_grads_int8(grads, err_state):
    """Error-feedback int8 quantization, one scale per reference leaf: g +
    e over every layer of the leaf, scaled by max |g + e| / 127, rounded
    half to even and clipped to +-127.  Returns (the dequantized gradients
    in f32, mirroring ``grads``; the new error, ``err_state`` updated in
    place)."""
    deq_of = {}
    with torch.no_grad():
        for path, entries in lm_groups(grads).items():
            err = at_path(err_state, path)
            errs = ([err] if entries[0][0] is None
                    else [err[i] for i, _ in entries])
            gs = [g.float() + e for (_, g), e in zip(entries, errs)]
            amax = torch.stack([torch.abs(g).max() for g in gs]).max()
            scale = torch.clamp_min(amax, 1e-8) / 127.0
            for (layer, _), g, e in zip(entries, gs, errs):
                deq = torch.clamp(torch.round(g / scale), -127, 127) * scale
                e.copy_(like(g - deq, e))
                deq_of[(path, layer)] = deq
    return map_lm_tree(grads, lambda p, i, _: deq_of[(p, i)]), err_state


def _live(params):
    """``params`` with each tensor replaced by a detached alias that
    requires grad, and those aliases in tree order."""
    live = []

    def alias(_p, _i, t):
        a = t.detach().requires_grad_(True)
        live.append(a)
        return a
    return map_lm_tree(params, alias), live


def _grads(loss, live_tree, live):
    """d loss / d each alias, zeros for a parameter the loss does not use
    (hubert's token embedding), as a tree mirroring the parameters."""
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    by_id = {id(a): (torch.zeros_like(a) if g is None else g)
             for a, g in zip(live, gs)}
    return map_lm_tree(live_tree, lambda _p, _i, a: by_id[id(a)])


def make_loss_and_grad(cfg: ModelConfig, n_microbatches: int = 1):
    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch)

    def detached(metrics):
        return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in metrics.items()}

    if n_microbatches <= 1:
        def total_grad(params, batch):
            live_tree, live = _live(params)
            loss, metrics = loss_fn(live_tree, batch)
            grads = _grads(loss, live_tree, live)
            return loss.detach(), detached(metrics), grads
        return total_grad

    def total_grad(params, batch):
        def reshape_mb(x):
            # a batch split over more devices than divide the microbatch
            # count is gathered first: no microbatch spans a device's rows
            x = whole_over(x, 0, n_microbatches)
            return x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                             *x.shape[1:])
        mb = {k: reshape_mb(v) for k, v in batch.items()}
        live_tree, live = _live(params)
        acc = map_lm_tree(params, lambda _p, _i, t: torch.zeros_like(
            t, dtype=torch.float32))
        acc_leaves = [t for _, _, t in lm_leaves(acc)]
        loss_sum = 0.0
        for i in range(n_microbatches):
            loss, metrics = loss_fn(live_tree, {k: v[i] for k, v in mb.items()})
            grads = _grads(loss, live_tree, live)
            for a, (_, _, g) in zip(acc_leaves, lm_leaves(grads)):
                a.add_(like(g.float(), a))
            loss_sum = loss_sum + loss.detach()
            del grads
        for a in acc_leaves:
            a.div_(n_microbatches)
        return loss_sum / n_microbatches, detached(metrics), acc
    return total_grad


def train_step_fn(cfg: ModelConfig, opt: OptConfig, n_microbatches: int = 1,
                  compress: bool = False, grad_shardings=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    params and state are updated in place (``adamw_update``).
    ``grad_shardings`` (``NamedSharding``s in the reference's layout): lay
    each gradient out as given before the optimizer reads it."""
    total_grad = make_loss_and_grad(cfg, n_microbatches)

    def step(params, opt_state, batch):
        loss, metrics, grads = total_grad(params, batch)
        if grad_shardings is not None:
            # pin gradients to the parameter layouts before the optimizer
            # reads them: under FSDP each device then reduces only its
            # shard (a reduce-scatter, not an all-reduce and a slice)
            grads = distribute(grads, grad_shardings)
        if compress:
            grads, err = compress_grads_int8(grads, opt_state["err"])
        params, inner, opt_metrics = adamw_update(
            params, grads, opt_state["opt"], opt)
        new_state = {"opt": inner}
        if compress:
            new_state["err"] = err
        metrics = {**metrics, **opt_metrics, "total_loss": loss}
        return params, new_state, metrics
    return step


def make_train_state(cfg: ModelConfig, opt: OptConfig, params,
                     compress: bool = False) -> Dict:
    state = {"opt": init_opt_state(params, opt)}
    if compress:
        state["err"] = stacked_zeros(params, torch.float32)
    return state


def make_sharded_train_step(cfg: ModelConfig, opt: OptConfig, mesh,
                            global_batch: int, n_microbatches: int = 1,
                            compress: bool = False):
    """The train step over ``mesh`` and its (param, state, batch) specs.

    ``mesh`` a named ``launch.mesh.Mesh``: parameters, state and batch are
    laid out by the spec tables (``specs.distribute``: a plain tensor is
    split locally, a ``DTensor`` kept or redistributed) and the step runs
    under the activation rules; it returns the parameters and state as
    ``DTensor``s, updated in place, and the metrics gathered to full
    tensors.  ``mesh`` a list of one device (``launch.mesh.make_host_mesh``,
    the counterpart of the reference's one-device host mesh):
    ``train_step_fn``'s step, and no specs (None, None, None)."""
    if global_batch % max(1, n_microbatches):
        raise ValueError(f"batch {global_batch} does not split into "
                         f"{n_microbatches} microbatches")
    if not isinstance(mesh, Mesh):
        if len(mesh) != 1:
            raise ValueError(f"a train step over {len(mesh)} devices takes a "
                             f"named mesh (launch.mesh.make_mesh), not a "
                             f"device list")
        return (train_step_fn(cfg, opt, n_microbatches, compress),
                (None, None, None))
    abstract = param_structs(cfg)
    p_specs = sanitize_specs(param_specs(cfg, mesh), abstract, mesh)
    o_specs = {"opt": opt_state_specs(p_specs, opt, abstract)}
    if compress:
        o_specs["err"] = p_specs
    b_specs = batch_specs(cfg, mesh, global_batch, "train")
    kv_tp_ok = ("model" not in mesh.axis_names
                or cfg.kv_heads % mesh.shape["model"] == 0)
    rules = make_rules(mesh, batch_sharded=batch_sharded(
        mesh, cfg.shard_strategy, global_batch),
        strategy=cfg.shard_strategy, kv_tp_ok=kv_tp_ok)
    p_sh = to_shardings(p_specs, mesh)
    inner = sharded(train_step_fn(
        cfg, opt, n_microbatches, compress,
        grad_shardings=p_sh if cfg.grad_reduce == "pinned" else None), rules)
    o_sh, b_sh = to_shardings(o_specs, mesh), to_shardings(b_specs, mesh)

    def step(params, opt_state, batch):
        params, opt_state, metrics = inner(
            distribute(params, p_sh), distribute(opt_state, o_sh),
            distribute(batch, b_sh))
        return params, opt_state, full(metrics)
    return step, (p_specs, o_specs, b_specs)


__all__ = ("compress_grads_int8", "make_loss_and_grad",
           "make_sharded_train_step", "make_train_state", "train_step_fn")
