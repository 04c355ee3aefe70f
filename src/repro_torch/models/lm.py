"""Model assembly for every family: forward pass (training / prefill), the
loss, and single-token decode (the JAX package's ``models/lm.py``, in
PyTorch).

dense:  embed -> per-layer [RMSNorm, attention, residual, RMSNorm, MLP,
        residual] -> final RMSNorm -> tied logits.
paligemma: the dense skeleton behind an image prefix: the image embeddings
        times ``img_proj`` go before the scaled text embeddings, attention
        is prefix-LM (bidirectional over the image, causal after it), and
        the logits are the text positions'.  Decode is the dense path's,
        with no image, as in the reference.
hubert: an encoder: frame features times ``frontend_proj`` (masked frames
        replaced by ``mask_embed``), dense layers with full attention and a
        gelu MLP, untied logits over the codebook; no decode.
moe:    the dense skeleton with the MLP replaced by the MoE block
        (``models/moe.py``); its load-balance loss, summed over the layers
        and divided by their number, is ``forward``'s ``aux``.
rwkv6:  embed -> per-layer RWKV-6 block (time mix with the WKV, channel
        mix) -> final RMSNorm -> tied logits.
zamba2: embed -> groups of ``shared_attn_every`` Mamba-2 layers, each group
        followed by the one shared attention + MLP block -> final RMSNorm
        -> tied logits.

A Python loop over ``params["layers"]`` takes the place of the reference's
``lax.scan``.  When a parameter requires grad (training), each layer (each
hubert and rwkv6 block, each Mamba-2 layer of zamba2) runs under
``torch.utils.checkpoint``: its activations are recomputed in the backward
pass, as the reference's ``jax.checkpoint`` of the scanned block does.
Serving, whose parameters require no grad, runs the layers as they are.
The decode cache is updated in place, where the reference donates it to
``jit``.

The functions are sharding-agnostic: a sharded step (``serve/serve_step``,
``train/train_step``) runs them on ``DTensor``s under its activation rules,
and ``sharding.ctx.constrain`` pins the hidden states and logits at the
reference's places (a plain tensor passes through unchanged).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, _leaves, check_family
from repro_torch.models.layers import (GLOBAL_WINDOW, attention_block,
                                       decode_attention, mlp, rms_norm, rope,
                                       split_heads)
from repro_torch.models.mamba2 import mamba2_layer
from repro_torch.models.moe import moe_block
from repro_torch.models.rwkv6 import rwkv6_decode_step, rwkv6_layer
from repro_torch.sharding.ctx import (activation_sharding, constrain,
                                      current_rules, like, per_device,
                                      shard_offset)


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (gemma3 local:global / SWA / full)."""
    L = cfg.n_layers
    if cfg.global_every:
        return [cfg.sliding_window if (i + 1) % cfg.global_every else
                GLOBAL_WINDOW for i in range(L)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * L
    return [GLOBAL_WINDOW] * L


def _remat(params):
    """How to call a layer: under ``torch.utils.checkpoint`` (non-reentrant,
    its activations recomputed in the backward pass) when grad is enabled
    and a parameter requires grad, else directly."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in _leaves(params)):
        # the backward's recompute may run on another thread (the card's
        # autograd thread), where the caller's activation rules are unset
        rules = current_rules()

        def under_rules(fn, *args):
            with activation_sharding(rules):
                return fn(*args)
        return lambda fn, *args: checkpoint(under_rules, fn, *args,
                                            use_reentrant=False)
    return lambda fn, *args: fn(*args)


def _embed(params, cfg, tokens):
    h = _lookup(params["embed"], tokens).to(cfg.dtype) * (cfg.d_model ** 0.5)
    return constrain(h, "hidden")


def _lookup(embed, tokens):
    """``embed[tokens]``.  On DTensors per device (``local_map``): the
    table gathered along its model dim (an FSDP gather), its vocabulary
    kept split where it is, each device picking the rows of its tokens
    that fall in its slice (zero elsewhere) and the slices summed (a
    vocab-parallel lookup); the table's gradient is a partial sum over the
    devices that split the tokens."""
    placements = getattr(embed, "placements", None)
    if placements is None:
        return embed[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = embed.device_mesh
    vocab = [pl.is_shard(0) and not tp.is_shard()
             for pl, tp in zip(placements, tokens.placements)]
    tok_pl = [Replicate() if v else tp
              for v, tp in zip(vocab, tokens.placements)]
    emb_pl = [Shard(0) if v else Replicate() for v in vocab]
    out_pl = [Partial() if v else tp for v, tp in zip(vocab, tok_pl)]
    v0 = shard_offset(embed.shape[0], mesh, emb_pl, 0)
    split = any(vocab)

    def local(emb, tok):
        if not split:
            return emb[tok]
        t = tok.long() - v0
        inside = (t >= 0) & (t < emb.shape[0])
        rows = emb[t.clamp(0, emb.shape[0] - 1)]
        return torch.where(inside[..., None], rows, 0)
    return per_device(local, out_pl, (emb_pl, tok_pl), mesh)(embed, tokens)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return constrain(h @ head.to(h.dtype), "logits")


# ---------------------------------------------------------------------------
# Forward pass (training / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens=None, *, features=None,
            feat_mask=None, img_embeds=None, block_kv: int = 0):
    """tokens (B, S) -> (logits (B, S, V), aux_loss scalar); ``aux`` is the
    MoE load-balance loss averaged over the layers, 0 for the other
    families.  paligemma takes ``img_embeds`` (B, P, d), the image prefix
    (the logits stay (B, S, V)); hubert takes ``features`` (B, S, d) and
    an optional boolean ``feat_mask`` (B, S) in place of tokens."""
    check_family(cfg)
    block_kv = block_kv or cfg.attn_block_kv or (1 << 30)
    if cfg.family == "hubert":
        return _forward_hubert(params, cfg, features, feat_mask, block_kv)
    if cfg.family == "rwkv6":
        return _forward_rwkv6(params, cfg, tokens)
    if cfg.family == "zamba2":
        return _forward_zamba2(params, cfg, tokens, block_kv)
    h = _embed(params, cfg, tokens)
    prefix_len = None
    if cfg.family == "paligemma" and img_embeds is not None:
        img = img_embeds.to(cfg.dtype) @ params["img_proj"]
        h = torch.cat([img, h], dim=1)
        prefix_len = img_embeds.shape[1]
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def block(h, aux, lp, win):
        hm = h.float() + attention_block(
            rms_norm(h, lp["norm1"]), lp["attn"], cfg, positions,
            causal=cfg.causal, window=win, prefix_len=prefix_len,
            block_kv=block_kv).float()
        # the norm reads the residual sum unrounded, as the reference's
        # compiled scan body does (XLA drops that bf16 rounding)
        f, a = _ffn(rms_norm(hm, lp["norm2"]).to(h.dtype), lp, cfg)
        return constrain(hm.to(h.dtype) + f, "hidden"), aux + a

    run = _remat(params)
    for lp, win in zip(params["layers"], layer_windows(cfg)):
        h, aux = run(block, h, aux, lp, win)
    logits = _logits(params, cfg, h)
    if prefix_len is not None:
        logits = logits[:, prefix_len:]
    return logits, aux / cfg.n_layers


def _forward_hubert(params, cfg, features, feat_mask, block_kv: int):
    """Encoder over (masked) frame features; predicts codebook targets."""
    h = constrain(features.to(cfg.dtype) @ params["frontend_proj"], "hidden")
    if feat_mask is not None:
        h = torch.where(feat_mask[..., None],
                        params["mask_embed"].to(cfg.dtype)[None, None, :], h)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]

    def block(h, lp):
        # the second norm reads the residual sum unrounded, as in the
        # dense block
        hm = h.float() + attention_block(
            rms_norm(h, lp["norm1"]), lp["attn"], cfg, positions,
            causal=False, window=GLOBAL_WINDOW, block_kv=block_kv).float()
        f = mlp(rms_norm(hm, lp["norm2"]).to(h.dtype), lp["mlp"], cfg.mlp_act)
        return constrain(hm.to(h.dtype) + f, "hidden")

    run = _remat(params)
    for lp in params["layers"]:
        h = run(block, h, lp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux


def _ffn(h, lp, cfg):
    """The feed-forward sub-block of a dense or moe layer: (out, aux)."""
    if cfg.family == "moe":
        return moe_block(h, lp["moe"], cfg)
    return mlp(h, lp["mlp"], cfg.mlp_act), 0.0


def _forward_rwkv6(params, cfg, tokens):
    """Every block starts from zero token-shift and channel-mix states (in
    ``cfg.dtype``) and a zero WKV state."""
    h = _embed(params, cfg, tokens)
    zeros = torch.zeros((h.shape[0], cfg.d_model), dtype=cfg.dtype,
                        device=h.device)

    def block(h, lp):
        return constrain(rwkv6_layer(h, zeros, zeros, lp, cfg)[0], "hidden")

    run = _remat(params)
    for lp in params["layers"]:
        h = run(block, h, lp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _pick(logits, targets):
    """``logits[..., targets]`` at every position.  On DTensors whose
    vocabulary is split over devices each device picks the targets that
    fall in its slice (zero elsewhere) and the picks are summed across
    the slices (a vocab-parallel gather), so no device holds the whole
    vocabulary."""
    placements = getattr(logits, "placements", None)
    if placements is None:
        return logits.gather(-1, targets[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    last, mesh = logits.ndim - 1, logits.device_mesh
    v0 = shard_offset(logits.shape[-1], mesh, placements, last)

    def local(lg, tg):
        t = tg.long() - v0
        inside = (t >= 0) & (t < lg.shape[-1])
        picked = lg.gather(-1, t.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(inside, picked[..., 0], 0.0)
    out = [Partial() if p.is_shard(last) else p for p in placements]
    rows = [Replicate() if p.is_shard(last) else p for p in placements]
    return per_device(local, out, (list(placements), rows), mesh)(
        logits, targets)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, Any],
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Next-token loss on ``batch["tokens"]`` (B, S) under the optional
    ``loss_mask`` (B, S) (paligemma: behind ``batch["img_embeds"]``), or
    for hubert the masked prediction of ``batch["targets"]`` (B, S) from
    ``batch["features"]`` at the frames of ``batch["mask"]``; in f32, plus
    the z-loss and the weighted aux loss; returns (loss, metrics)."""
    if cfg.family == "hubert":
        logits, aux = forward(params, cfg, features=batch["features"],
                              feat_mask=batch["mask"])
        targets, mask = batch["targets"].long(), batch["mask"]
    else:
        tokens = batch["tokens"]
        inp, targets = tokens[:, :-1], tokens[:, 1:].long()
        mask = batch.get("loss_mask")
        mask = (torch.ones_like(targets, dtype=torch.bool) if mask is None
                else mask[:, 1:])
        logits, aux = forward(params, cfg, inp,
                              img_embeds=batch.get("img_embeds"))
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = _pick(logits, targets)
    nll = (logz - ll) * mask
    denom = torch.clamp_min(mask.sum(), 1)
    loss = nll.sum() / denom
    zloss = z_weight * (logz.square() * mask).sum() / denom
    total = loss + zloss + aux_weight * aux
    return total, {"loss": loss, "zloss": zloss, "aux": aux,
                   "tokens": denom}


def _shared_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """zamba2: the shared block's period k and its number of applications."""
    k = cfg.shared_attn_every or cfg.n_layers
    return k, cfg.n_layers // k


def _forward_zamba2(params, cfg, tokens, block_kv: int):
    """Mamba2 backbone with the shared attention block every k layers."""
    h = _embed(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    k, G = _shared_groups(cfg)
    sp = params["shared"]

    def layer(h, lp):
        return constrain(mamba2_layer(h, lp, cfg)[0], "hidden")

    run = _remat(params)
    for g in range(G):
        for lp in params["layers"][g * k:(g + 1) * k]:
            h = run(layer, h, lp)
        # the shared block's second norm reads the residual sum unrounded,
        # as in the dense block
        hm = h.float() + attention_block(
            rms_norm(h, sp["norm1"]), sp["attn"], cfg, positions,
            causal=True, window=GLOBAL_WINDOW, block_kv=block_kv).float()
        f = mlp(rms_norm(hm, sp["norm2"]).to(h.dtype), sp["mlp"], cfg.mlp_act)
        h = constrain(hm.to(h.dtype) + f, "hidden")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    """Zeroed decode cache; ``len`` is the number of positions written, a
    Python int.  dense and moe: KV cache (L, batch, max_len, KV, D) in
    ``cfg.dtype``.  rwkv6: per layer the WKV state (L, batch, H, K, K) in
    f32 and the token-shift and channel-mix states (L, batch, d) in
    ``cfg.dtype``; no KV cache, so no length limit.  zamba2: per layer the
    conv window (L, batch, K - 1, d_in + 2N) in ``cfg.dtype`` and the SSM
    state (L, batch, H, P, N) in f32, and a KV cache (G, batch, max_len,
    KV, D) for the G applications of the shared block.  hubert, an
    encoder, has none and raises ``ValueError``."""
    check_family(cfg)
    if cfg.family == "hubert":
        raise ValueError(f"no decode cache for {cfg.family} (encoder-only)")
    n_kv = cfg.n_layers
    cache: Dict[str, Any] = {}
    if cfg.family == "rwkv6":
        L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
        K = d // H
        cache["wkv"] = torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                                   device=device)
        for name in ("tmix", "cmix"):
            cache[name] = torch.zeros((L, batch, d), dtype=cfg.dtype,
                                      device=device)
        cache["len"] = 0
        return cache
    if cfg.family == "zamba2":
        H, P, N, d_in = cfg.ssm_dims()
        n_kv = _shared_groups(cfg)[1]
        cache["conv"] = torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                     d_in + 2 * N), dtype=cfg.dtype,
                                    device=device)
        cache["ssm"] = torch.zeros((cfg.n_layers, batch, H, P, N),
                                   dtype=torch.float32, device=device)
    shape = (n_kv, batch, max_len, cfg.kv_heads, cfg.hd)
    cache["k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    cache["len"] = 0
    return cache


def _write(dst, src) -> None:
    """``dst.copy_(src)`` in place; a sharded ``src`` is first laid out as
    the cache's ``dst`` is."""
    dst.copy_(like(src, dst))


def _write_position(kc, pos, k) -> None:
    """``kc[:, pos] = k[:, 0]`` in place, for a cache (B, Smax, KV, D) and a
    step's keys or values (B, 1, KV, D).  A sharded cache whose sequence
    axis is split (the sequence-parallel cache of ``cache_specs``) is
    written on the device that holds ``pos``, in its local shard."""
    placements = getattr(kc, "placements", None)
    if placements is None:
        kc[:, pos] = k[:, 0]
        return
    from torch.distributed.tensor import Replicate
    whole_seq = [Replicate() if p.is_shard(1) else p for p in placements]
    if whole_seq == list(placements):
        kc[:, pos].copy_(like(k[:, 0], kc[:, pos]))
        return
    k = k.redistribute(kc.device_mesh, whole_seq).to_local()
    local = kc.to_local()
    start = shard_offset(kc.shape[1], kc.device_mesh, placements, 1)
    if start <= pos < start + local.shape[1]:
        local[:, pos - start] = k[:, 0]


def _attend(h, p, cfg, cache, i, positions, window):
    """One decode step of attention over KV cache slot ``i``: projections,
    qk-norm, RoPE at ``positions`` (a (1, 1) tensor holding the step's
    position ``cache["len"]``), the step's keys and values written there in
    place, attention over the cache, output projection."""
    B = h.shape[0]
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.hd
    pos = cache["len"]
    q = split_heads(h @ p["wq"], H, D)
    k = split_heads(h @ p["wk"], KV, D)
    v = split_heads(h @ p["wv"], KV, D)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kc, vc = cache["k"][i], cache["v"][i]
    _write_position(kc, pos, k)
    _write_position(vc, pos, v)
    o = decode_attention(q, kc, vc, pos + 1, window=window)
    return o.reshape(B, 1, H * D) @ p["wo"]


def decode_step(params, cfg: ModelConfig, cache, token):
    """One decode step.  token: (B, 1) int -> (logits (B,1,V), cache).

    Updates ``cache`` in place (keys and values; rwkv6's WKV, token-shift
    and channel-mix states; zamba2's conv windows and SSM states) and
    returns it with ``len`` advanced by one.  paligemma decodes text only,
    as the reference does; hubert has no decode step."""
    check_family(cfg)
    if cfg.family == "hubert":
        raise ValueError(f"no decode step for {cfg.family} (encoder-only)")
    pos = cache["len"]
    if "k" in cache and pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions; "
                         f"position {pos} does not fit")
    h = _embed(params, cfg, token)                       # (B, 1, d)
    positions = torch.full((1, 1), pos, device=h.device)
    if cfg.family == "rwkv6":
        h = _decode_rwkv6(params, cfg, cache, h)
    elif cfg.family == "zamba2":
        h = _decode_zamba2(params, cfg, cache, h, positions)
    else:
        for i, (lp, win) in enumerate(zip(params["layers"],
                                          layer_windows(cfg))):
            h = h + _attend(rms_norm(h, lp["norm1"]), lp["attn"], cfg, cache,
                            i, positions, win)
            h = h + _ffn(rms_norm(h, lp["norm2"]), lp, cfg)[0]
    cache["len"] = pos + 1
    return _logits(params, cfg, h), cache


def _decode_rwkv6(params, cfg, cache, h):
    """rwkv6's layers for one decode step: each advances its WKV,
    token-shift and channel-mix states in place."""
    h = h[:, 0]                                          # (B, d)
    for i, lp in enumerate(params["layers"]):
        h, tmix, cmix, wkv = rwkv6_decode_step(
            h, cache["tmix"][i], cache["cmix"][i], cache["wkv"][i], lp, cfg)
        _write(cache["tmix"][i], tmix)
        _write(cache["cmix"][i], cmix)
        _write(cache["wkv"][i], wkv)
    return h[:, None, :]


def _decode_zamba2(params, cfg, cache, h, positions):
    """zamba2's layers for one decode step: each Mamba-2 layer advances its
    conv window and SSM state in place, each shared block its KV slot."""
    k, G = _shared_groups(cfg)
    sp = params["shared"]
    for g in range(G):
        for i in range(g * k, (g + 1) * k):
            h, conv, ssm = mamba2_layer(h, params["layers"][i], cfg,
                                        conv_state=cache["conv"][i],
                                        ssm_state=cache["ssm"][i],
                                        decode=True)
            _write(cache["conv"][i], conv)
            _write(cache["ssm"][i], ssm)
        h = h + _attend(rms_norm(h, sp["norm1"]), sp["attn"], cfg, cache, g,
                        positions, GLOBAL_WINDOW)
        h = h + mlp(rms_norm(h, sp["norm2"]), sp["mlp"], cfg.mlp_act)
    return h
