"""Zamba2-2.7B: Mamba2 backbone + shared attention block (hybrid).
[arXiv:2411.15242; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="zamba2",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_conv=4, ssm_head_dim=64,
    shared_attn_every=6, mlp_act="silu",
)
