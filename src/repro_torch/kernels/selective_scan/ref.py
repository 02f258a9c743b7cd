"""Plain PyTorch selective scans: the CPU path of ``ops`` and the oracles
the CUDA kernel is held against on the card.

``selective_scan_ref`` is the port of ``src/repro/kernels/selective_scan/
ref.py`` (the sequential recurrence, one step at a time).
``fused_scan_ref`` is the port of ``src/repro/models/ssm.py::_fused_scan``:
chunks of 128 steps chained in order, each solved by a log-step
(Hillis-Steele) inclusive scan with the discretisation done inside the
chunk, so it costs some tens of ops per chunk instead of some per step and
never holds more than one chunk's [B, Q, D, N].
"""
from __future__ import annotations

from typing import Tuple

import torch

CHUNK = 128


def selective_scan_ref(a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Sequential scan.  a, b [B,S,D,N]; c [B,S,N] -> y [B,S,D] float32
    (h_0 = 0)."""
    a, b, c = a.float(), b.float(), c.float()
    bsz, s, d, n = a.shape
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=a.device)
    ys = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.sum(h * c[:, t, None, :], dim=-1))
    return torch.stack(ys, dim=1)


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor):
    """Hillis-Steele scan along dim 1 of the affine maps h -> a h + b:
    after it, (a[t], b[t]) composes steps 0..t of the chunk."""
    q = a.shape[1]
    off = 1
    while off < q:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return a, b


def fused_scan_ref(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a_neg: torch.Tensor, h0: torch.Tensor,
                   chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x [B,S,D]; bmat, cmat [B,S,N]; a_neg [D,N]; h0 [B,D,N] ->
    (y [B,S,D], h_last [B,D,N]), float32, with a_t = exp(dt * a_neg) and
    b_t = (dt * x) * bmat."""
    dt, x, bmat, cmat = dt.float(), x.float(), bmat.float(), cmat.float()
    h = h0.float()
    ys = []
    for c0 in range(0, dt.shape[1], chunk):
        dt_c = dt[:, c0:c0 + chunk]
        a_t = torch.exp(dt_c[..., None] * a_neg)                 # [B,Q,D,N]
        b_t = (dt_c * x[:, c0:c0 + chunk])[..., None] \
            * bmat[:, c0:c0 + chunk, None, :]
        a_cum, b_cum = _inclusive_scan(a_t, b_t)
        h_chunk = a_cum * h[:, None] + b_cum
        ys.append(torch.sum(h_chunk * cmat[:, c0:c0 + chunk, None, :],
                            dim=-1))
        h = h_chunk[:, -1]
    return torch.cat(ys, dim=1), h
