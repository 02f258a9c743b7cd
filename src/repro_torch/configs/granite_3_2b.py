"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base; hf-verified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv=8, d_head=64,
    d_ff=8192, vocab=49155, rope_theta=1e7, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, tie_embeddings=True)
