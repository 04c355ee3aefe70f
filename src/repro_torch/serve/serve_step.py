"""Serving steps: batched prefill and single-token decode, unsharded and
sharded (the JAX package's ``serve/serve_step.py``, in PyTorch).

``make_sharded_prefill`` / ``make_sharded_decode`` lay parameters, batch
and decode cache out by ``sharding.specs`` (batch over DP, kv-heads over TP
when divisible, else a sequence-sharded cache) as ``DTensor``s over the
mesh's ``DeviceMesh``, and run the unsharded step functions under the
activation rules: ``jit``'s ``in_shardings`` become ``specs.distribute``,
which splits a plain input locally and keeps one already laid out.  The
reference donates the decode cache to ``jit``; here the step updates the
cache's shards in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.launch.input_specs import param_structs
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import whole_over
from repro_torch.models.lm import decode_step, forward
from repro_torch.sharding.ctx import make_rules, sharded
from repro_torch.sharding.specs import (NamedSharding, P, batch_sharded,
                                        batch_specs, cache_specs, distribute,
                                        dp_axes, param_specs, sanitize_specs,
                                        to_shardings)


def _sanitized_param_specs(cfg: ModelConfig, mesh: Mesh):
    return sanitize_specs(param_specs(cfg, mesh), param_structs(cfg), mesh)


def prefill_fn(cfg: ModelConfig):
    """Last-position logits of a batch: ``tokens`` (and paligemma's
    ``img_embeds``), or hubert's ``features`` and optional ``mask``."""
    def prefill(params, batch):
        if cfg.family == "hubert":
            logits, _ = forward(params, cfg, features=batch["features"],
                                feat_mask=batch.get("mask"))
        else:
            logits, _ = forward(params, cfg, batch["tokens"],
                                img_embeds=batch.get("img_embeds"))
        # serving returns last-position logits per request
        return logits[:, -1, :]
    return prefill


def decode_fn(cfg: ModelConfig):
    def decode(params, cache, token):
        logits, cache = decode_step(params, cfg, cache, token)
        # the greedy pick reads the whole vocabulary on every device
        last = whole_over(logits[:, -1, :], 1, 1)
        next_tok = torch.argmax(last, dim=-1, keepdim=True)
        return next_tok.to(torch.int32), logits, cache
    return decode


def make_sharded_prefill(cfg: ModelConfig, mesh: Mesh, global_batch: int):
    """``(step, (param_specs, batch_specs))``: ``step(params, batch)`` gives
    the last-position logits as a ``DTensor``."""
    p_specs = _sanitized_param_specs(cfg, mesh)
    b_specs = batch_specs(cfg, mesh, global_batch, "prefill")
    rules = make_rules(mesh, batch_sharded=batch_sharded(
        mesh, cfg.shard_strategy, global_batch), strategy=cfg.shard_strategy)
    inner = sharded(prefill_fn(cfg), rules)
    p_sh, b_sh = to_shardings(p_specs, mesh), to_shardings(b_specs, mesh)

    def fn(params, batch):
        return inner(distribute(params, p_sh), distribute(batch, b_sh))
    return fn, (p_specs, b_specs)


def make_sharded_decode(cfg: ModelConfig, mesh: Mesh, batch: int):
    """``(step, (param_specs, cache_specs, token_spec))``: ``step(params,
    cache, token)`` gives (next token, logits, cache) as ``DTensor``s, the
    cache's shards updated in place."""
    p_specs = _sanitized_param_specs(cfg, mesh)
    c_specs = cache_specs(cfg, mesh, batch)
    tok_spec = P(dp_axes(mesh, cfg.shard_strategy) if batch > 1 else None,
                 None)
    rules = make_rules(mesh, batch_sharded=batch_sharded(
        mesh, cfg.shard_strategy, batch), strategy=cfg.shard_strategy)
    inner = sharded(decode_fn(cfg), rules)
    p_sh, c_sh = to_shardings(p_specs, mesh), to_shardings(c_specs, mesh)
    t_sh = NamedSharding(mesh, tok_spec)

    def fn(params, cache, token):
        return inner(distribute(params, p_sh), distribute(cache, c_sh),
                     t_sh.place(token))
    return fn, (p_specs, c_specs, tok_spec)


__all__ = ("decode_fn", "make_sharded_decode", "make_sharded_prefill",
           "prefill_fn")
