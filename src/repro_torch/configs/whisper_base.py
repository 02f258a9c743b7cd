"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865, enc-dec.

Conv/log-mel frontend is a STUB: the caller supplies precomputed frame
embeddings ``enc_embeds`` [B, 1500, 512].  long_500k skipped (full
attention).

[arXiv:2212.04356; unverified tier]
"""
from ..models.layers import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_head=64,
    d_ff=2048, vocab=51865, n_enc_layers=6, enc_seq=1500,
    frontend="embed",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
        d_ff=128, vocab=256, n_enc_layers=2, enc_seq=16,
        frontend="embed")
