"""Plain PyTorch attention: the CPU path of ``ops.flash_attention`` and the
oracle the CUDA kernel is held against.  Port of
``src/repro/kernels/flash_attention/ref.py``, which re-exports the model
zoo's ``naive_attention`` (``src/repro/models/attention.py``); the port's
``models/attention.py`` imports it from here."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def softmax_scale(dh: int) -> float:
    """1/sqrt(Dh) computed in float32, as the reference computes it.  A
    Python float, so that scaling and masking launch no host-to-device
    copy (a scalar tensor made on the host would be one, and would wait
    for the device)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,KV,Dh] -> [B,S,H,Dh] by repeating each kv head H/KV times."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Full-materialisation attention.  q [B,Sq,H,Dh], k/v [B,Skv,KV,Dh];
    scores in float32, the weights cast to v's dtype before the second
    product (as the reference does); out [B,Sq,H,Dh] in v's dtype."""
    h = q.shape[2]
    k, v = expand_kv(k, h), expand_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * softmax_scale(q.shape[-1])
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
