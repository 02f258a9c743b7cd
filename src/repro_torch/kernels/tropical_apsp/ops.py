"""Public min-plus product and APSP.

Port of ``src/repro/kernels/tropical_apsp/ops.py``.  A CPU tensor goes
through the plain version (``ref.py``), as the Pallas kernel ran in
interpret mode off the TPU; a CUDA tensor launches the hand-written kernel
(``kernel.py``) or raises.  Neither path falls back to the other.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import apsp_steps, minplus_matmul_ref


def minplus_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Z[i, j] = min_k X[i, k] + Y[k, j] (float32)."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return minplus_matmul_ref(x, y)
    return kernel.minplus_f32(x.to(torch.float32).contiguous(),
                              y.to(torch.float32).contiguous())


def apsp(adj: torch.Tensor, steps: int | None = None) -> torch.Tensor:
    """Tropical-semiring all-pairs shortest paths of ``adj [n, n]`` (edge
    weights, ``inf`` = no edge, 0 diagonal): ``ceil(log2 n)`` squarings.
    Unreachable pairs come out ``inf``."""
    d = adj.to(torch.float32).contiguous()
    for _ in range(apsp_steps(d.shape[0]) if steps is None else steps):
        d = minplus_matmul(d, d)
    return d
