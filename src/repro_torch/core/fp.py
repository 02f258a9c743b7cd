"""Fused multiply-add in float32, the way the reference computes it.

XLA's CPU backend contracts a float32 ``a * b + c`` inside one fusion into
a fused multiply-add, rounded once.  The reference engine relies on it at
every ``x + rate * dt`` style update (remaining bits and MI, energy, the
completion tolerances, host power).  PyTorch runs the two operations as
separate kernels, each rounding.  ``fma32`` evaluates ``a * b + c`` in
float64 — the float32 product is exact there — and rounds the sum to
float32 once more.  That equals the single-rounded fused result except
when the float64 sum lands exactly on a float32 rounding midpoint, which
happens with probability about 2**-29 per operation.  The same float64
ops give the same bits on the CPU and on CUDA.
"""
from __future__ import annotations

import torch


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (see the module note).
    Operands are float32 tensors or Python floats (taken as float32)."""
    # torchcheck: disable=f64-literal,tracer-cast: float64 product and sum
    # rounded once: a recorded divergence; a Python constant through a CPU
    # tensor, no device
    a, b, c = (x.to(torch.float64) if torch.is_tensor(x)
               else float(torch.tensor(x, dtype=torch.float32))
               for x in (a, b, c))
    return (a * b + c).to(torch.float32)
