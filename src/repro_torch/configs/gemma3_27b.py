"""Gemma-3 27B: 5:1 local:global attention, 128k context, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144, qk_norm=True,
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
    mlp_act="silu",
)
