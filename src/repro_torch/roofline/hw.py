"""Target-hardware constants: port of ``src/repro/roofline/hw.py``, kept
as data so the advisor's predictions equal the reference's.  These are
the reference's TPU v5e figures (the pod the advisor schedules
collectives for), not figures of the card the port runs on."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12      # FLOP/s per chip
    hbm_bw: float = 819e9                # bytes/s per chip
    ici_link_bw: float = 50e9            # bytes/s per link (one direction)
    ici_links: int = 4                   # 2D torus: +-x, +-y
    hbm_bytes: float = 16e9              # capacity per chip


V5E = HwSpec()
