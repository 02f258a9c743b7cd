"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE.  Backbone only: the vision frontend is a stub --
the caller supplies pre-merged text+vision embeddings ``embeds`` [B,S,D]
plus the M-RoPE position ids ``pos3`` [B,S,3] (t, h, w).

[arXiv:2409.12191; hf-verified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=29568, vocab=152064, mrope=True, rope_theta=1e6,
    frontend="embed",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
        d_ff=128, vocab=256, mrope=True, frontend="embed")
