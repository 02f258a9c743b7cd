"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free vocab=65024,
ssm_state=16 (mamba1 architecture). Runs long_500k (O(1) decode state).

[arXiv:2410.05355; unverified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_head=0,
    d_ff=0, vocab=65024, ssm_state=16, ssm_conv=4, ssm_expand=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv=0, d_head=0,
        d_ff=0, vocab=256, ssm_state=4, ssm_conv=4, ssm_expand=2)
