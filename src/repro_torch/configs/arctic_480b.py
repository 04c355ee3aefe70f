"""Snowflake Arctic (480B-class): 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, n_experts=128, n_shared_experts=0, top_k=2,
    expert_d_ff=4864, dense_residual=True, mlp_act="silu",
)
