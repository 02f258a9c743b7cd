"""Next-token cross-entropy with z-loss and padding mask: port of
``src/repro/train/loss.py``.

On a process group (``replicas`` given) each rank holds a piece of the
global batch, and the reference's loss is over the whole batch: its
masked sums over the **global** count of unmasked labels (GSPMD sums
them across the mesh).  The port's rank takes that count by one
all-reduce (without a gradient; a piece held by ``replicas`` ranks is
counted once) and returns the global values.  Its gradient is the world
size times its share of the global loss's (a piece held by ``replicas``
ranks gives each a ``1/replicas`` part), so that the mean of the ranks'
gradients (``zero.update``) is the reference's whatever the ranks'
counts: with replicas, without, and under the sequence split.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..sharding import tp

PAD_ID = -1


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 1e-4,
            aux_loss: Union[torch.Tensor, float] = 0.0,
            aux_weight: float = 1e-2, replicas: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B,S,V]; labels [B,S] int (``PAD_ID`` = ignore) -> (total,
    {"ce", "z", "aux", "tokens"}): the mean cross-entropy and z-loss
    (the squared logsumexp) over the unmasked positions, both from a
    float32 logsumexp, and the count of those positions (at least 1).
    With ``replicas`` (on a process group: the number of ranks that hold
    this rank's piece of the batch) the mean and the count are the
    global batch's (the module docstring); ``aux_loss`` is then taken to
    be global already."""
    logits = logits.float()
    mask = labels != PAD_ID
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold
    zl = torch.square(lse)
    count = mask.sum(dtype=torch.int32)
    sums = torch.stack([torch.where(mask, nll, 0.0).sum(),
                        torch.where(mask, zl, 0.0).sum()])
    if replicas is None:
        denom = torch.clamp_min(count, 1)
        ce, z = sums / denom
    else:
        import torch.distributed as dist
        pieces = dist.get_world_size() // replicas
        denom = torch.clamp_min(tp.world_sum(count) // replicas, 1)
        glob = tp.world_sum(sums) / (replicas * denom)
        ce, z = tp.valued(sums * pieces / denom, glob)
    total = ce + z_loss * z + aux_weight * aux_loss
    aux = (aux_loss if isinstance(aux_loss, torch.Tensor) else
           torch.full((), aux_loss, dtype=torch.float32,
                      device=logits.device))
    return total, {"ce": ce, "z": z, "aux": aux, "tokens": denom}
