"""Target-hardware constants: port of ``src/repro/roofline/hw.py``.

``V5E`` keeps the reference's TPU v5e figures as data, so the advisor (it
schedules collectives for a TPU pod) predicts what the reference does.
``H100`` is the card the port runs on, read by the roofline terms
(``terms.py``) and the dry run (``launch/dryrun.py``)."""
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

# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet): HBM3 at
# 3.35 TB/s, 989 TFLOP/s of dense bf16 on the tensor cores, 80 GB; fourth-
# generation NVLink at 900 GB/s a GPU in both directions over 18 links,
# i.e. 25 GB/s a link a direction.  The same peaks as ``chip_smoke.py``'s.
H100 = HwSpec(name="h100-sxm", peak_flops_bf16=989e12, hbm_bw=3.35e12,
              ici_link_bw=25e9, ici_links=18, hbm_bytes=80e9)

# What one GPU of a multi-node H100 mesh gets a direction for a collective
# whose ring leaves its node: one ConnectX-7 port at 400 Gb/s = 50 GB/s
# (NVIDIA DGX H100 user guide: eight single-port ConnectX-7 400 Gb/s
# adapters for the compute fabric, one a GPU).  A 16 x 16 mesh spans 32
# nodes of 8 GPUs, so the rings of both its axes cross nodes and this,
# not NVLink's 450 GB/s a direction inside a node, bounds them; the mesh
# dry run's ``collective_s`` divides by it.
H100_SCALEOUT_BW = 50e9
