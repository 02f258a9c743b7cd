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
"""
