"""Public selective scans.

Port of ``src/repro/kernels/selective_scan/ops.py``.  A CPU tensor goes
through the plain version (``ref.py``), as the Pallas kernel ran in
interpret mode off the TPU; a CUDA tensor launches the hand-written kernel
(``kernel.py``) or raises.  Neither path falls back to the other.  The
Pallas wrapper's ``chunk``, ``bd`` and ``interpret`` are TPU tiling and
interpret knobs with no meaning here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel
from .ref import fused_scan_ref, selective_scan_ref


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def selective_scan(a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """a, b [B,S,D,N]; c [B,S,N] -> y [B,S,D] float32 (h_0 = 0)."""
    if _on_cpu(a, b, c):
        return selective_scan_ref(a, b, c)
    return kernel.selective_scan_f32(a, b, c)


def selective_scan_fused(dt: torch.Tensor, x: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         a_neg: torch.Tensor, h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of ``models/ssm.py`` with the discretisation inside it:
    dt, x [B,S,D]; bmat, cmat [B,S,N]; a_neg [D,N]; h0 [B,D,N] ->
    (y [B,S,D], h_last [B,D,N]), float32."""
    if _on_cpu(dt, x, bmat, cmat, a_neg, h0):
        return fused_scan_ref(dt, x, bmat, cmat, a_neg, h0)
    return kernel.selective_scan_fused_f32(dt, x, bmat, cmat, a_neg, h0)
