"""Public GQA flash attention in the model layout.

Port of ``src/repro/kernels/flash_attention/ops.py``.  A CPU tensor goes
through the plain version (``ref.naive_attention``), as the Pallas kernel
ran in interpret mode off the TPU; a CUDA tensor launches the hand-written
kernel (``kernel.py``) or raises.  Neither path falls back to the other.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import naive_attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,Dh], k/v [B,Skv,KV,Dh] -> [B,Sq,H,Dh] in q's dtype."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return naive_attention(q, k, v, causal=causal,
                               q_offset=q_offset).to(q.dtype)
    return kernel.flash_attention_fwd(q, k, v, causal=causal,
                                      q_offset=q_offset)
