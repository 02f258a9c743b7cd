"""Next-token cross-entropy with z-loss and padding mask: port of
``src/repro/train/loss.py``."""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

PAD_ID = -1


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 1e-4,
            aux_loss: Union[torch.Tensor, float] = 0.0,
            aux_weight: float = 1e-2
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B,S,V]; labels [B,S] int (``PAD_ID`` = ignore) -> (total,
    {"ce", "z", "aux", "tokens"}): the mean cross-entropy and z-loss
    (the squared logsumexp) over the unmasked positions, both from a
    float32 logsumexp, and the count of those positions (at least 1)."""
    logits = logits.float()
    mask = labels != PAD_ID
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold
    zl = torch.square(lse)
    denom = torch.clamp_min(mask.sum(dtype=torch.int32), 1)
    ce = torch.where(mask, nll, 0.0).sum() / denom
    z = torch.where(mask, zl, 0.0).sum() / denom
    total = ce + z_loss * z + aux_weight * aux_loss
    aux = (aux_loss if isinstance(aux_loss, torch.Tensor) else
           torch.full((), aux_loss, dtype=torch.float32,
                      device=logits.device))
    return total, {"ce": ce, "z": z, "aux": aux, "tokens": denom}
