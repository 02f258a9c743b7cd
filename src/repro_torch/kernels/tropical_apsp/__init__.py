"""Tropical (min-plus) matrix product and APSP by repeated squaring: port
of ``src/repro/kernels/tropical_apsp`` (CUDA kernel in
``repro_torch/csrc/tropical_apsp.cu``)."""
from .ops import apsp, minplus_matmul
from .ref import apsp_early_stop_ref, apsp_ref, minplus_matmul_ref

__all__ = ["apsp", "apsp_early_stop_ref", "apsp_ref", "minplus_matmul",
           "minplus_matmul_ref"]
