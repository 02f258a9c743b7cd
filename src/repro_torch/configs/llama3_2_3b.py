"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

[hf:meta-llama/Llama-3.2-3B; unverified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8, d_head=128,
    d_ff=8192, vocab=128256, rope_theta=5e5, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv=1, d_head=16,
        d_ff=96, vocab=256, tie_embeddings=True)
