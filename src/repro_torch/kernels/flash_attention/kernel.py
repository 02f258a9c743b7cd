"""ctypes binding of ``csrc/flash_attention.cu``: flash attention (forward)
on a CUDA device.

Port of the Pallas kernel ``src/repro/kernels/flash_attention/kernel.py``
(``_fa_kernel`` / ``flash_attention_bhsd``) together with its GQA wrapper
``ops.py``: the kernel reads the model layout [B, S, H, Dh] through its
strides and maps each query head to its kv head by index, so nothing is
transposed, repeated or padded here.  The source note in the ``.cu`` file
says what bounds it on an H100 and how it is laid out.  The library is
built with ``nvcc`` on the first launch, not at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, refuse_autograd

HEAD_DIMS = (16, 32, 64, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
# the C entry's code for a TMA descriptor that cuTensorMapEncodeTiled refused
_ERR_TENSOR_MAP = -1

_lib = None
_launches = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.flash_attention_kernel_info.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _library()


def kernel_info(dtype: torch.dtype, dh: int) -> dict:
    """Registers a thread, static and dynamic shared memory (bytes) a
    block, resident blocks an SM and threads a block of the kernel behind
    ``dtype``'s entry at head size ``dh``, from ``cudaFuncGetAttributes``
    and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    out = (ctypes.c_int * 5)()
    rc = _library().flash_attention_kernel_info(
        int(dtype == torch.bfloat16), dh, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_kernel_info failed: CUDA error "
                           f"{rc}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "threads"), out))


def launch_count() -> int:
    """Launches of the flash-attention kernel since import or the last
    reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + mask) v on one CUDA device.

    q [B, Sq, H, Dh], k and v [B, Skv, KV, Dh], all float32 or all bfloat16,
    unit stride along Dh (other strides are free), H a multiple of KV, Dh in
    ``HEAD_DIMS``, ``q_offset >= 0`` (the absolute position of query row 0
    under the causal mask).  Returns a contiguous [B, Sq, H, Dh] tensor in
    q's dtype.  bf16 tensors are read by TMA, which also needs every base
    address and every stride 16-byte aligned.  Raises on anything else,
    and under autograd (``refuse_autograd``: the kernel has no backward)
    before anything else."""
    global _launches
    refuse_autograd("flash_attention_fwd", q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_fwd needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 "
                        f"alike, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, skv, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or kv < 1 or h % kv:
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd takes Dh in {HEAD_DIMS}, "
                         f"got {dh}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_fwd needs unit stride along Dh")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3]):
                raise ValueError(
                    f"flash_attention_fwd: bf16 {name} needs a 16-byte "
                    f"aligned base and strides (TMA), got strides "
                    f"{t.stride()} at offset {t.data_ptr() % 16}")
    q_offset = int(q_offset)
    if q_offset < 0 or q_offset >= 1 << 30:
        raise ValueError(f"flash_attention_fwd: q_offset {q_offset} out of "
                         f"range")
    if min(b, sq, h, skv) < 1 or b * h >= 1 << 16 or max(sq, skv) >= 1 << 30:
        raise ValueError(f"flash_attention_fwd sizes out of range: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    fn = getattr(_library(), _ENTRY[q.dtype])
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, skv, h, kv, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(bool(causal)), q_offset, dh ** -0.5, stream)
    if rc == _ERR_TENSOR_MAP:
        raise RuntimeError("flash_attention_fwd: cuTensorMapEncodeTiled "
                           "refused a TMA descriptor for q, k or v")
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc}")
    _launches += 1
    return o
