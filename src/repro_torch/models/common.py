"""Model configuration and parameter initialisation (the JAX package's
``models/common.py``, in PyTorch).

``ModelConfig`` keeps every field of the reference, so that its
architectures describe themselves the same way in both packages; ``dtype``
is a ``torch.dtype``.  Parameters are plain nested dicts of tensors.  Where
the reference stacks per-layer weights on a leading axis for ``lax.scan``,
the port keeps one dict per layer in ``params["layers"]`` and loops over
them in Python.  The layout, besides ``embed``, ``final_norm`` (and
``lm_head`` when untied):

  dense   ``layers[i]`` = {``attn``, ``mlp``, ``norm1``, ``norm2``}; the
          hubert and paligemma families have the same layers
  moe     ``layers[i]`` = {``attn``, ``moe``, ``norm1``, ``norm2``}; ``moe`` =
          {``router`` (d, E) f32, ``we_gate``/``we_up`` (E, d, f),
          ``we_down`` (E, f, d), the shared experts ``ws_gate``/``ws_up``
          (d, S f) and ``ws_down`` (S f, d) when ``n_shared_experts`` = S >
          0, and a dense MLP ``dense`` when ``dense_residual``}
  rwkv6   ``layers[i]`` = one RWKV-6 block {``mix``, ``wr``, ``wk``, ``wv``,
          ``wg``, ``ww``, ``w_bias``, ``u``, ``wo``, ``ln_x``, ``ffn_k``,
          ``ffn_v``, ``ffn_r``, ``norm1``, ``norm2``}
  zamba2  ``layers[i]`` = one Mamba-2 mixer {``w_in``, ``conv_w``, ``A_log``,
          ``D``, ``dt_bias``, ``w_out``, ``norm``, ``gate_norm``};
          ``shared`` = the one attention + MLP block applied after every
          ``shared_attn_every`` layers, {``attn``, ``mlp``, ``norm1``,
          ``norm2``} (the reference's ``shared_*`` entries, unstacked)

and, by the config's ``frontend``: ``audio`` (hubert) adds
``frontend_proj`` (d, d) and ``mask_embed`` (d,), ``image`` (paligemma)
adds ``img_proj`` (d, d).  Every family of the reference is ported.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

#: the model families, as the reference names them
FAMILIES = ("dense", "moe", "rwkv6", "zamba2", "hubert", "paligemma")


def check_family(cfg: "ModelConfig") -> None:
    """Raise ``ValueError`` unless ``cfg``'s family is one of
    ``FAMILIES``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv6 | zamba2 | hubert | paligemma
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0              # 0 -> = n_heads
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention flavor
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention
    global_every: int = 0            # gemma3: every Nth layer global (0 = all)
    causal: bool = True
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False     # arctic: dense FFN alongside experts
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    shared_attn_every: int = 0       # zamba2: shared attention period
    # modality frontend (stub supplies embeddings)
    frontend: str = "none"           # none | audio | image
    n_prefix_tokens: int = 0         # paligemma image tokens
    # numerics
    dtype: Any = torch.bfloat16
    mlp_act: str = "silu"            # silu | gelu
    tie_embeddings: bool = True
    # distribution (sharding/specs.py): tp2d = FSDP(data) x TP(model), fsdp
    # = ZeRO-3 over (data, model); pinned grad_reduce lays gradients out as
    # their parameters before the optimizer
    shard_strategy: str = "tp2d"
    grad_reduce: str = "auto"
    # KV block size of the plain blockwise attention (0 = one full block)
    attn_block_kv: int = 512
    moe_groups: int = 1
    attn_head_shard: str = "auto"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def ssm_dims(self):
        """Mamba-2 widths (H, P, N, d_in): H = 2 d_model / P heads of width
        P = ``ssm_head_dim`` (expand factor 2), state width N, d_in = H P."""
        P = self.ssm_head_dim
        H = max(1, (2 * self.d_model) // P)
        return H, P, self.ssm_state, H * P

    # -- parameter counting ------------------------------------------------
    def param_count(self) -> int:
        c = self
        d, hd = c.d_model, c.hd
        emb = c.vocab * d
        per_layer = 0
        if c.family in ("dense", "moe", "hubert", "paligemma"):
            attn = d * hd * (c.n_heads + 2 * c.kv_heads) + c.n_heads * hd * d
            per_layer += attn + 2 * d                      # + norms
            if c.family == "moe":
                eff = c.expert_d_ff or c.d_ff
                per_layer += 3 * d * eff * (c.n_experts + c.n_shared_experts)
                per_layer += d * c.n_experts               # router
                if c.dense_residual:
                    per_layer += 3 * d * c.d_ff
            else:
                n_mats = 3 if c.mlp_act == "silu" else 2
                per_layer += n_mats * d * c.d_ff
        elif c.family == "rwkv6":
            # the reference's approximate formula: the tree holds
            # 7 d^2 + 2 d d_ff + 6 d a layer
            per_layer = 6 * d * d + 3 * d * c.d_ff + 4 * d
        elif c.family == "zamba2":
            d_in = 2 * d
            per_layer = (d * (2 * d_in + 2 * c.ssm_state) + d_in * d
                         + 4 * d)                           # mamba2 mixer approx
        n = emb + c.n_layers * per_layer
        if c.family == "zamba2" and c.shared_attn_every:
            attn = d * hd * (c.n_heads + 2 * c.kv_heads) + c.n_heads * hd * d
            n += attn + 3 * d * c.d_ff
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        c = self
        d = c.d_model
        eff = c.expert_d_ff or c.d_ff
        total = self.param_count()
        inactive = 3 * d * eff * (c.n_experts - c.top_k) * c.n_layers
        return total - inactive


# ---------------------------------------------------------------------------
# Initializers (one dict per layer)
# ---------------------------------------------------------------------------

def _dense(gen: torch.Generator, shape, device, dtype, scale=None):
    """Normal(0, 1) * scale (default 1/sqrt(fan_in)), drawn in f32 one
    tensor at a time and cast to ``dtype``."""
    scale = scale or (1.0 / math.sqrt(shape[-2] if len(shape) > 1
                                      else shape[-1]))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def init_attention(gen, c: ModelConfig, device, dtype) -> Dict:
    d, hd, H, KV = c.d_model, c.hd, c.n_heads, c.kv_heads
    p = {
        "wq": _dense(gen, (d, H * hd), device, dtype),
        "wk": _dense(gen, (d, KV * hd), device, dtype),
        "wv": _dense(gen, (d, KV * hd), device, dtype),
        "wo": _dense(gen, (H * hd, d), device, dtype),
    }
    if c.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def init_mlp(gen, d_in, d_ff, act, device, dtype) -> Dict:
    p = {
        "w_up": _dense(gen, (d_in, d_ff), device, dtype),
        "w_down": _dense(gen, (d_ff, d_in), device, dtype),
    }
    if act == "silu":
        p["w_gate"] = _dense(gen, (d_in, d_ff), device, dtype)
    return p


def init_moe(gen, c: ModelConfig, device, dtype) -> Dict:
    """One MoE block: the f32 router (at 0.02), the routed experts' gated
    MLPs stacked on a leading expert axis, the shared experts' MLP fused
    to width ``n_shared_experts`` f, and arctic's dense residual MLP."""
    d, E = c.d_model, c.n_experts
    eff = c.expert_d_ff or c.d_ff
    p = {
        "router": _dense(gen, (d, E), device, torch.float32, scale=0.02),
        "we_gate": _dense(gen, (E, d, eff), device, dtype),
        "we_up": _dense(gen, (E, d, eff), device, dtype),
        "we_down": _dense(gen, (E, eff, d), device, dtype),
    }
    if c.n_shared_experts:
        S = c.n_shared_experts
        p["ws_gate"] = _dense(gen, (d, S * eff), device, dtype)
        p["ws_up"] = _dense(gen, (d, S * eff), device, dtype)
        p["ws_down"] = _dense(gen, (S * eff, d), device, dtype)
    if c.dense_residual:
        p["dense"] = init_mlp(gen, d, c.d_ff, c.mlp_act, device, dtype)
    return p


def init_mamba2(gen, c: ModelConfig, device, dtype) -> Dict:
    """One Mamba-2 mixer: the fused input projection to (x, gate, B, C, dt),
    the depthwise conv over (x, B, C), and f32 ``A_log``/``dt_bias``."""
    d = c.d_model
    H, _, N, d_in = c.ssm_dims()

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)
    return {
        "w_in": _dense(gen, (d, 2 * d_in + 2 * N + H), device, dtype),
        "conv_w": _dense(gen, (c.ssm_conv, d_in + 2 * N), device, dtype,
                         scale=0.5),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": ones(H),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "w_out": _dense(gen, (d_in, d), device, dtype),
        "norm": ones(d),
        "gate_norm": ones(d_in),
    }


def init_rwkv6(gen, c: ModelConfig, device, dtype) -> Dict:
    """One RWKV-6 block: the token-shift mixes of r, k, v, w, g (at 0.5),
    the time-mix projections, the data-dependent decay ``ww`` (at 0.01) and
    its bias ``w_bias`` (-5), the bonus ``u`` (at 0.5), the channel mix,
    and the norms (ones)."""
    d = c.d_model

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    def dense(*shape, scale=None):
        return _dense(gen, shape, device, dtype, scale=scale)
    return {
        "mix": dense(5, d, scale=0.5),
        "wr": dense(d, d),
        "wk": dense(d, d),
        "wv": dense(d, d),
        "wg": dense(d, d),
        "ww": dense(d, d, scale=0.01),
        "w_bias": torch.full((d,), -5.0, dtype=dtype, device=device),
        "u": dense(d, scale=0.5),
        "wo": dense(d, d),
        "ln_x": ones(),
        "ffn_k": dense(d, c.d_ff),
        "ffn_v": dense(c.d_ff, d),
        "ffn_r": dense(d, d),
        "norm1": ones(),
        "norm2": ones(),
    }


def init_params(gen: torch.Generator, c: ModelConfig, device) -> Dict:
    """Random parameters, drawn from ``gen`` (a generator on ``device``)
    with the reference's shapes and scales: normal times 1/sqrt(fan_in),
    the embedding, hubert's ``mask_embed`` and the MoE router times 0.02
    (the router in f32), the
    conv, rwkv6's mixes and ``u`` times 0.5,
    its ``ww`` times 0.01, norms and ``D`` set to ones, ``w_bias`` to -5,
    ``A_log`` and ``dt_bias`` to f32 zeros.  Weights are made one
    tensor at a time, so no f32 copy of the model is ever held."""
    check_family(c)
    dtype, d = c.dtype, c.d_model

    def block(cfg):
        return {"attn": init_attention(gen, cfg, device, dtype),
                "mlp": init_mlp(gen, d, c.d_ff, c.mlp_act, device, dtype),
                "norm1": torch.ones((d,), dtype=dtype, device=device),
                "norm2": torch.ones((d,), dtype=dtype, device=device)}
    params: Dict[str, Any] = {
        "embed": _dense(gen, (c.vocab, d), device, dtype, scale=0.02),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not c.tie_embeddings:
        params["lm_head"] = _dense(gen, (d, c.vocab), device, dtype)
    if c.family == "rwkv6":
        params["layers"] = [init_rwkv6(gen, c, device, dtype)
                            for _ in range(c.n_layers)]
    elif c.family == "moe":
        params["layers"] = [
            {"attn": init_attention(gen, c, device, dtype),
             "moe": init_moe(gen, c, device, dtype),
             "norm1": torch.ones((d,), dtype=dtype, device=device),
             "norm2": torch.ones((d,), dtype=dtype, device=device)}
            for _ in range(c.n_layers)]
    elif c.family == "zamba2":
        params["layers"] = [init_mamba2(gen, c, device, dtype)
                            for _ in range(c.n_layers)]
        # the shared block is a dense, MHA-or-GQA block with no qk-norm
        shared = ModelConfig(name="shared", family="dense", n_layers=1,
                             d_model=d, n_heads=c.n_heads, d_ff=c.d_ff,
                             vocab=1, n_kv_heads=c.n_kv_heads, dtype=dtype)
        params["shared"] = block(shared)
    else:
        params["layers"] = [block(c) for _ in range(c.n_layers)]
    if c.frontend == "audio":
        params["frontend_proj"] = _dense(gen, (d, d), device, dtype)
        params["mask_embed"] = _dense(gen, (d,), device, dtype, scale=0.02)
    if c.frontend == "image":
        params["img_proj"] = _dense(gen, (d, d), device, dtype)
    return params


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))
