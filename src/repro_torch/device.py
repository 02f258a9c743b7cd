"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and runs on CUDA unless the caller asks
for the CPU.  There is no silent fallback: asking for CUDA (explicitly or
by default) on a machine without a CUDA device raises.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; a string or ``torch.device`` is taken as given.
    Raises ``RuntimeError`` for a CUDA device when none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
