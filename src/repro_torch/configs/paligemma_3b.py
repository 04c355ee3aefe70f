"""PaliGemma-3B: SigLIP patch embeddings (stub) + Gemma MQA backbone.
[arXiv:2407.07726; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="paligemma",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, frontend="image", n_prefix_tokens=256,
    mlp_act="silu",
)
