"""Flash attention (forward): port of ``src/repro/kernels/flash_attention``
(CUDA kernel in ``repro_torch/csrc/flash_attention.cu``)."""
from .ops import flash_attention
from .ref import naive_attention

__all__ = ["flash_attention", "naive_attention"]
