"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave (attn_every=8 -> 4 attention
layers), MoE 16 experts top-2 on every 2nd layer.  Runs long_500k.

[arXiv:2403.19887; hf-verified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_head=128,
    d_ff=14336, vocab=65536, attn_every=8,
    n_experts=16, top_k=2, d_ff_expert=14336, moe_every=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, attn_every=2,
        n_experts=4, top_k=2, d_ff_expert=128, moe_every=2,
        ssm_state=4, ssm_conv=4, ssm_expand=2)
