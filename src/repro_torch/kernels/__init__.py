"""Hand-written CUDA kernels of the port.

Each kernel lives at ``kernels/<name>/{kernel.py, ops.py, ref.py}`` with its
CUDA C++ source in ``repro_torch/csrc/<name>.cu``:

* ``csrc/<name>.cu`` exposes a plain C function (no PyTorch headers) that
  launches on the stream it is given and returns ``cudaGetLastError()``;
* ``kernel.py`` builds it with ``nvcc`` at first use (``_build.load``),
  binds it with ``ctypes``, checks its tensors and counts its launches;
* ``ref.py`` is the plain PyTorch version of the same function;
* ``ops.py`` is the public wrapper: the plain version for CPU tensors, the
  kernel for CUDA tensors — never a fallback from one to the other.

No kernel has a backward (nor has the reference's Pallas kernel a VJP):
each entry raises under autograd instead of returning an output with no
``grad_fn``, which would cut the graph and leave every weight upstream of
it a zero gradient.  Training runs the plain backends.
"""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: the
    kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the port's CUDA kernels have no backward; an input "
            f"requires grad under grad mode, and the kernel's output would "
            f"cut the graph.  Train through a plain backend "
            f"(backend=\"chunked\") or call it under torch.no_grad()")
