"""ctypes binding of ``csrc/selective_scan.cu``: the Mamba1 selective scan
on a CUDA device.

Port of the Pallas kernel ``src/repro/kernels/selective_scan/kernel.py``
(``_scan_kernel`` / ``selective_scan``), and of the jnp scan the
reference's model runs in its place (``src/repro/models/ssm.py::
_fused_scan``): two entry points of one CUDA source.  The source note in
the ``.cu`` file says what bounds it on an H100 and how it is laid out.
The library is built with ``nvcc`` on the first launch, not at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, refuse_autograd

STATE_SIZES = (1, 2, 4, 8, 16, 32)   # N: a power of two that divides 32

ENTRIES = ("selective_scan_f32", "selective_scan_fused_f32")

# the kernels of the library, by the index selective_scan_kernel_info takes
KERNELS = ("pallas", "fused")

_lib = None
_launches = dict.fromkeys(ENTRIES, 0)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("selective_scan")
        lib.selective_scan_f32.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
        lib.selective_scan_f32.restype = ctypes.c_int
        lib.selective_scan_fused_f32.argtypes = ([ctypes.c_void_p] * 8
                                                 + [ctypes.c_int] * 4
                                                 + [ctypes.c_void_p])
        lib.selective_scan_fused_f32.restype = ctypes.c_int
        lib.selective_scan_kernel_info.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.selective_scan_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _library()


def kernel_info(kernel: str, n: int) -> dict:
    """Registers a thread, static and dynamic shared memory (bytes) a
    block, resident blocks an SM and threads a block of one of ``KERNELS``
    at state size ``n``, from ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    out = (ctypes.c_int * 5)()
    rc = _library().selective_scan_kernel_info(KERNELS.index(kernel), n, out)
    if rc != 0:
        raise RuntimeError(f"selective_scan_kernel_info failed: CUDA error "
                           f"{rc}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "threads"), out))


def launch_count() -> int:
    """Launches of either selective-scan entry point since import or the
    last reset."""
    return sum(_launches.values())


def launch_counts() -> dict:
    """Launches of each entry point (``ENTRIES``) since import or the last
    reset."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in ENTRIES:
        _launches[name] = 0


def _check(name: str, tensors: dict, shapes: dict) -> torch.device:
    """Every tensor float32, contiguous, on one CUDA device, of its shape."""
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs every tensor on one CUDA device, "
                             f"got {key} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {key} {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors, {key} is not")
    return dev


def _check_sizes(name: str, bsz: int, s: int, d: int, n: int) -> None:
    if n not in STATE_SIZES:
        raise ValueError(f"{name} takes N in {STATE_SIZES} (a power of two "
                         f"that divides 32), got N={n}")
    if min(bsz, s, d) < 1 or bsz >= 1 << 16 or max(s, d) >= 1 << 30:
        raise ValueError(f"{name} sizes out of range: B={bsz} S={s} D={d}")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    _launches[name] += 1


def selective_scan_f32(a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """y [B,S,D] with h_t = a_t h_{t-1} + b_t (h_0 = 0) and
    y_t[d] = sum_n h_t[d,n] c_t[n], for float32 contiguous CUDA tensors
    a, b [B,S,D,N] and c [B,S,N].  Raises on anything else, and under
    autograd (``refuse_autograd``) before anything else."""
    refuse_autograd("selective_scan_f32", a, b, c)
    if a.dim() != 4:
        raise ValueError(f"selective_scan_f32: a has shape {tuple(a.shape)}, "
                         f"expected [B, S, D, N]")
    bsz, s, d, n = a.shape
    _check_sizes("selective_scan_f32", bsz, s, d, n)
    dev = _check("selective_scan_f32", {"a": a, "b": b, "c": c},
                 {"a": (bsz, s, d, n), "b": (bsz, s, d, n),
                  "c": (bsz, s, n)})
    fn = _library().selective_scan_f32
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launched("selective_scan_f32",
              fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                 bsz, s, d, n, stream))
    return y


def selective_scan_fused_f32(dt: torch.Tensor, x: torch.Tensor,
                             bmat: torch.Tensor, cmat: torch.Tensor,
                             a_neg: torch.Tensor, h0: torch.Tensor):
    """(y [B,S,D], h_last [B,D,N]) of the scan with a_t = exp(dt * a_neg)
    and b_t = (dt * x) * bmat computed in the kernel, from h0.  dt, x
    [B,S,D], bmat, cmat [B,S,N], a_neg [D,N], h0 [B,D,N]: float32,
    contiguous, 16-byte aligned, on one CUDA device.  Raises on anything
    else, and under autograd (``refuse_autograd``) before anything else."""
    refuse_autograd("selective_scan_fused_f32", dt, x, bmat, cmat, a_neg,
                    h0)
    if dt.dim() != 3 or a_neg.dim() != 2:
        raise ValueError(f"selective_scan_fused_f32: dt {tuple(dt.shape)}, "
                         f"a_neg {tuple(a_neg.shape)}: expected [B, S, D] "
                         f"and [D, N]")
    bsz, s, d = dt.shape
    n = a_neg.shape[1]
    _check_sizes("selective_scan_fused_f32", bsz, s, d, n)
    dev = _check("selective_scan_fused_f32",
                 {"dt": dt, "x": x, "bmat": bmat, "cmat": cmat,
                  "a_neg": a_neg, "h0": h0},
                 {"dt": (bsz, s, d), "x": (bsz, s, d), "bmat": (bsz, s, n),
                  "cmat": (bsz, s, n), "a_neg": (d, n), "h0": (bsz, d, n)})
    for key, t in (("a_neg", a_neg), ("h0", h0)):
        if t.data_ptr() % 16:
            raise ValueError(f"selective_scan_fused_f32 reads {key} as "
                             f"float4s and needs it 16-byte aligned")
    fn = _library().selective_scan_fused_f32
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launched("selective_scan_fused_f32",
              fn(dt.data_ptr(), x.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), a_neg.data_ptr(), h0.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), bsz, s, d, n, stream))
    return y, h_last
