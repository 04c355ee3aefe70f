"""Model assembly for the dense family: forward pass (training / prefill)
and single-token decode (the JAX package's ``models/lm.py``, in PyTorch).

embed -> per-layer [RMSNorm, attention, residual, RMSNorm, MLP, residual]
-> final RMSNorm -> tied logits.  A Python loop over ``params["layers"]``
takes the place of the reference's ``lax.scan``.  The decode cache is
updated in place, where the reference donates it to ``jit``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models.common import ModelConfig, check_family
from repro_torch.models.layers import (GLOBAL_WINDOW, attention_block,
                                       decode_attention, mlp, rms_norm, rope)


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (gemma3 local:global / SWA / full)."""
    L = cfg.n_layers
    if cfg.global_every:
        return [cfg.sliding_window if (i + 1) % cfg.global_every else
                GLOBAL_WINDOW for i in range(L)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * L
    return [GLOBAL_WINDOW] * L


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(cfg.dtype) * (cfg.d_model ** 0.5)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return h @ head.to(h.dtype)


# ---------------------------------------------------------------------------
# Forward pass (training / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, *, block_kv: int = 0):
    """tokens (B, S) -> (logits (B, S, V), aux_loss scalar)."""
    check_family(cfg)
    block_kv = block_kv or cfg.attn_block_kv or (1 << 30)
    h = _embed(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for lp, win in zip(params["layers"], layer_windows(cfg)):
        h = h + attention_block(rms_norm(h, lp["norm1"]), lp["attn"], cfg,
                                positions, causal=cfg.causal, window=win,
                                block_kv=block_kv)
        h = h + mlp(rms_norm(h, lp["norm2"]), lp["mlp"], cfg.mlp_act)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    """Zeroed KV cache (L, batch, max_len, KV, D) in ``cfg.dtype``; ``len``
    is the number of positions written, a Python int."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": 0}


def decode_step(params, cfg: ModelConfig, cache, token):
    """One decode step.  token: (B, 1) int -> (logits (B,1,V), cache).

    Writes the step's keys and values into ``cache`` in place and returns
    it with ``len`` advanced by one."""
    check_family(cfg)
    B = token.shape[0]
    pos = cache["len"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions; "
                         f"position {pos} does not fit")
    h = _embed(params, cfg, token)                       # (B, 1, d)
    positions = torch.full((1, 1), pos, device=h.device)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.hd
    for i, (lp, win) in enumerate(zip(params["layers"], layer_windows(cfg))):
        x = rms_norm(h, lp["norm1"])
        p = lp["attn"]
        q = (x @ p["wq"]).reshape(B, 1, H, D)
        k = (x @ p["wk"]).reshape(B, 1, KV, D)
        v = (x @ p["wv"]).reshape(B, 1, KV, D)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
            k = rms_norm(k, p["k_norm"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        o = decode_attention(q, kc, vc, pos + 1, window=win)
        h = h + o.reshape(B, 1, H * D) @ p["wo"]
        h = h + mlp(rms_norm(h, lp["norm2"]), lp["mlp"], cfg.mlp_act)
    cache["len"] = pos + 1
    return _logits(params, cfg, h), cache
