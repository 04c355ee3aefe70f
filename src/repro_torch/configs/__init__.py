"""Architecture registry: ``--arch <id>`` resolves through ``get_config``.

Every architecture of the JAX package's registry, at its published
widths: the dense ones, the MoE ones (deepseek-moe-16b, arctic-480b),
rwkv6-1.6b, zamba2-2.7b, the audio encoder hubert-xlarge and the
image-prefix LM paligemma-3b.  ``smoke_config`` gives a reduced
same-family configuration for CPU tests, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube3
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube18
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.models.common import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_deepseek, _arctic, _gemma3, _qwen3, _danube3,
                        _danube18, _hubert, _paligemma, _rwkv6, _zamba2)
}

FAMILIES = {name: c.family for name, c in ARCHS.items()}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny layers/width/experts/vocab/image
    prefix (the reference's reductions)."""
    c = get_config(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256,
        head_dim=16, rope_theta=10000.0,
    )
    if c.n_kv_heads:
        kw["n_kv_heads"] = min(c.n_kv_heads, 2)
    if c.family == "moe":
        kw.update(n_experts=8, top_k=min(c.top_k, 2),
                  n_shared_experts=min(c.n_shared_experts, 1),
                  expert_d_ff=32,
                  capacity_factor=8.0)   # ~dropless so decode == forward
    if c.family == "rwkv6":
        kw.update(n_heads=4, d_model=64)          # head size 16
    if c.family == "zamba2":
        kw.update(n_layers=4, shared_attn_every=2, ssm_state=16,
                  ssm_head_dim=16, n_kv_heads=4)
    if c.sliding_window:
        kw["sliding_window"] = 8
    if c.global_every:
        kw["global_every"] = 2
    if c.n_prefix_tokens:
        kw["n_prefix_tokens"] = 4
    return dataclasses.replace(c, **kw)
