"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8, qk_norm.

[hf:Qwen/Qwen3-30B-A3B; hf-verified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_head=128,
    d_ff=768, vocab=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8, d_ff_expert=768, moe_every=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=32, vocab=256, qk_norm=True,
        n_experts=8, top_k=2, d_ff_expert=32)
