"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, n_heads=32, d_ff=7168, vocab=65536,
    mlp_act="silu",
)
