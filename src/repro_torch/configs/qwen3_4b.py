"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm + GQA, head_dim=128 (Qwen3 decouples head_dim from d_model/n_heads).
[hf:Qwen/Qwen3-8B family; hf-verified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv=8, d_head=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, qk_norm=True)
