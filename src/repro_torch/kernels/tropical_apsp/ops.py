"""Public min-plus product and APSP.

Port of ``src/repro/kernels/tropical_apsp/ops.py``.  A CPU tensor goes
through the plain version (``ref.py``), as the Pallas kernel ran in
interpret mode off the TPU; a CUDA tensor launches the hand-written kernel
(``kernel.py``) or raises.  Neither path falls back to the other.  On CUDA
an APSP is one launch, whatever the number of squarings.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import apsp_ref, minplus_matmul_ref


def minplus_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Z[i, j] = min_k X[i, k] + Y[k, j] (float32)."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return minplus_matmul_ref(x, y)
    return kernel.minplus_f32(x.to(torch.float32).contiguous(),
                              y.to(torch.float32).contiguous())


def apsp(adj: torch.Tensor, steps: int | None = None) -> torch.Tensor:
    """Tropical-semiring all-pairs shortest paths of ``adj [n, n]`` (edge
    weights, ``inf`` = no edge, 0 diagonal): at most ``ceil(log2 n)``
    squarings.  Unreachable pairs come out ``inf``.  On CUDA the squarings
    stop once the distances settle, which changes no bit."""
    d = adj.to(torch.float32)
    if d.device.type == "cpu" or steps == 0:
        return apsp_ref(d, steps)
    return kernel.apsp_f32(d.contiguous(), steps)
