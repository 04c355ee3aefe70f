"""HuBERT X-Large: encoder-only audio transformer (stub frame frontend).
[arXiv:2106.07447; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="hubert",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, causal=False, frontend="audio", mlp_act="gelu",
    tie_embeddings=False,
)
