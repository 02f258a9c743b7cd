"""Mamba1 selective scan: port of ``src/repro/kernels/selective_scan``
(CUDA kernel in ``repro_torch/csrc/selective_scan.cu``)."""
from .ops import selective_scan, selective_scan_fused
from .ref import fused_scan_ref, selective_scan_ref

__all__ = ["fused_scan_ref", "selective_scan", "selective_scan_fused",
           "selective_scan_ref"]
