"""DeepSeek-MoE-16B: fine-grained experts, 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, n_experts=64, n_shared_experts=2, top_k=6,
    expert_d_ff=1408, mlp_act="silu",
)
