"""ctypes binding of ``csrc/tropical_apsp.cu``: the min-plus product on a
CUDA device.

Port of the Pallas kernel ``src/repro/kernels/tropical_apsp/kernel.py``
(``_minplus_kernel`` / ``minplus_matmul``); the source note in the ``.cu``
file says what bounds it on an H100 and how it is laid out.  The library is
built with ``nvcc`` on the first launch, not at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_lib = None
_launches = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("tropical_apsp")
        lib.minplus_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.minplus_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _library()


def launch_count() -> int:
    """Launches of the min-plus kernel since import or the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def minplus_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Z = X (min,+) Y for float32 CUDA matrices ``x [m, k]``, ``y [k, n]``,
    both contiguous and on the same device.  Raises on anything else."""
    global _launches
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"minplus_f32 needs both operands on one CUDA "
                         f"device, got {x.device} and {y.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"minplus_f32 takes float32, got {x.dtype}, "
                        f"{y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"minplus_f32 shapes {tuple(x.shape)} x "
                         f"{tuple(y.shape)} do not chain")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("minplus_f32 takes contiguous operands")
    m, k = x.shape
    n = y.shape[1]
    if min(m, k, n) < 1 or max(m, k, n) >= 1 << 21:
        raise ValueError(f"minplus_f32 sizes ({m}, {k}, {n}) out of range")
    lib = _library()
    z = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.minplus_f32(x.data_ptr(), y.data_ptr(), z.data_ptr(), m, k, n,
                         stream)
    if rc != 0:
        raise RuntimeError(f"minplus_f32 launch failed: CUDA error {rc}")
    _launches += 1
    return z
