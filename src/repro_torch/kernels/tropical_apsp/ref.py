"""Plain PyTorch min-plus product and APSP: the CPU path and the oracle the
CUDA kernel is held against.  Port of
``src/repro/kernels/tropical_apsp/ref.py``, with the early-stopping loop
of the kernel's one-launch APSP."""
from __future__ import annotations

import math

import torch

_CHUNK_ELEMS = 1 << 24  # bound on the [m, kc, n] broadcast per chunk


def _minplus_chunked(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """min_k x[:, k] + y[k, :], chunked over k so the broadcast stays
    bounded; min is exact, so chunking changes no bit."""
    m, k = x.shape
    n = y.shape[1]
    kc = max(1, _CHUNK_ELEMS // max(1, m * n))
    out = None
    for k0 in range(0, k, kc):
        part = (x[:, k0:k0 + kc, None] + y[None, k0:k0 + kc, :]).amin(1)
        out = part if out is None else torch.minimum(out, part)
    return out


def minplus_matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Z[i, j] = min_k X[i, k] + Y[k, j] in float32."""
    return _minplus_chunked(x.to(torch.float32), y.to(torch.float32))


def apsp_steps(n: int) -> int:
    """Squarings that cover every path of up to n - 1 edges."""
    return max(1, math.ceil(math.log2(max(2, n))))


def apsp_ref(adj: torch.Tensor, steps: int | None = None) -> torch.Tensor:
    """All-pairs shortest paths by repeated min-plus squaring."""
    d = adj.to(torch.float32)
    for _ in range(apsp_steps(d.shape[0]) if steps is None else steps):
        d = minplus_matmul_ref(d, d)
    return d


def apsp_early_stop_ref(adj: torch.Tensor, steps: int | None = None):
    """The one-launch kernel's loop: at most ``steps`` squarings, stopping
    after the first that changes no bit.  Returns (distances, squarings
    run); the distances equal ``apsp_ref``'s (a settled matrix squares to
    itself)."""
    d = adj.to(torch.float32)
    steps = apsp_steps(d.shape[0]) if steps is None else steps
    for s in range(steps):
        nd = minplus_matmul_ref(d, d)
        if torch.equal(nd.view(torch.int32), d.view(torch.int32)):
            return nd, s + 1
        d = nd
    return d, steps
