"""Serving steps: batched prefill and single-token decode.

The JAX package's ``make_sharded_prefill`` / ``make_sharded_decode`` wait
for a sharded port (ROADMAP A10); one card runs these unsharded.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import decode_step, forward


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
        next_tok = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
        return next_tok.to(torch.int32), logits, cache
    return decode
