"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16, MHA) expert
d_ff=1408 vocab=163840, MoE 64 experts top-6 (kimi/moonlight lineage).

[hf:moonshotai/Moonlight-16B-A3B; hf-verified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=163840, rope_theta=5e4,
    n_experts=64, top_k=6, d_ff_expert=1408, moe_every=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
        d_ff=64, vocab=256, n_experts=8, top_k=2, d_ff_expert=64)
