"""ctypes binding of ``csrc/tropical_apsp.cu``: the min-plus product and
the whole APSP on a CUDA device.

Port of the Pallas kernel ``src/repro/kernels/tropical_apsp/kernel.py``
(``_minplus_kernel`` / ``minplus_matmul``) and of the squaring loop of
``ops.py::apsp``; the source note in the ``.cu`` file says what bounds it
on an H100 and how it is laid out.  Two entry points share one tile
routine: ``minplus_f32`` (one product) and ``apsp_f32`` (every squaring in
one cooperative launch that stops when the distances settle).  The
library is built with ``nvcc`` on the first launch, not at import.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from .ref import apsp_steps

# the entries of the library, by the index tropical_apsp_kernel_info takes
ENTRIES = ("minplus_f32", "apsp_f32")
# square output tiles, by the index the C entries take as `tile`
TILES = (16, 32, 64, 128)
# the H100's SMs: what tile_for assumes when not told the card's count
H100_SMS = 132

_lib = None
_launches = dict.fromkeys(ENTRIES, 0)
_last_squarings = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("tropical_apsp")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.minplus_f32.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.apsp_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.tropical_apsp_kernel_info.argtypes = [
            i32, i32, ctypes.POINTER(ctypes.c_int)]
        for name in ENTRIES + ("tropical_apsp_kernel_info",):
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _library()


def launch_count() -> int:
    """Launches of any min-plus entry since import or the last reset: one
    a product (``minplus_f32``), one a whole APSP (``apsp_f32``)."""
    return sum(_launches.values())


def launch_counts() -> dict:
    """Launches of each entry point (``ENTRIES``) since import or the last
    reset."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in ENTRIES:
        _launches[name] = 0


def last_squarings():
    """The squarings the last ``apsp_f32`` launch ran, as a 0-d int32 tensor
    on its device (read it with ``int(...)``, which waits for the launch);
    ``None`` before the first launch."""
    return _last_squarings


def tile_for(m: int, n: int | None = None, sms: int = H100_SMS) -> int:
    """The tile (one of ``TILES``) for an [m, n] output: the largest whose
    grid has at least one tile for each of ``sms`` SMs, else the smallest.
    At n = 153, 16 x 16 tiles give 100 blocks where 32 x 32 give 25."""
    n = m if n is None else n
    for tile in reversed(TILES[1:]):
        if math.ceil(m / tile) * math.ceil(n / tile) >= sms:
            return tile
    return TILES[0]


def kernel_info(entry: str, tile: int) -> dict:
    """Registers a thread, static and dynamic shared memory (bytes) a
    block, resident blocks an SM and threads a block of one of ``ENTRIES``
    at one of ``TILES``, from ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    out = (ctypes.c_int * 5)()
    rc = _library().tropical_apsp_kernel_info(ENTRIES.index(entry),
                                              TILES.index(tile), out)
    if rc != 0:
        raise RuntimeError(f"tropical_apsp_kernel_info failed: CUDA error "
                           f"{rc}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "threads"), out))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident_blocks(entry: str, tile: int, device: torch.device) -> int:
    with torch.cuda.device(device):
        return kernel_info(entry, tile)["blocks_per_sm"] * _sms(device)


def persistent_grid(entry: str, tile: int, n: int,
                    device: torch.device) -> int:
    """Blocks of an ``apsp_f32`` launch at size n: as many as the card holds
    at once (blocks an SM times its SMs), and no more than the tiles."""
    return min(_resident_blocks(entry, tile, device),
               math.ceil(n / tile) ** 2)


def _check(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs its operands on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if t.dtype != dtype:
            raise TypeError(f"{name} takes {dtype}, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} takes matrices, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous operands")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    _launches[name] += 1


def minplus_f32(x: torch.Tensor, y: torch.Tensor,
                tile: int | None = None) -> torch.Tensor:
    """Z = X (min,+) Y for float32 CUDA matrices ``x [m, k]``, ``y [k, n]``,
    both contiguous and on the same device; ``tile`` (one of ``TILES``)
    defaults to ``tile_for(m, n)``.  Raises on anything else."""
    _check("minplus_f32", torch.float32, x, y)
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"minplus_f32 shapes {tuple(x.shape)} x "
                         f"{tuple(y.shape)} do not chain")
    m, k = x.shape
    n = y.shape[1]
    if min(m, k, n) < 1 or max(m, k, n) >= 1 << 21:
        raise ValueError(f"minplus_f32 sizes ({m}, {k}, {n}) out of range")
    tile = tile_for(m, n, _sms(x.device)) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"minplus_f32 tile {tile} is not one of {TILES}")
    lib = _library()
    z = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launched("minplus_f32",
              lib.minplus_f32(x.data_ptr(), y.data_ptr(), z.data_ptr(), m,
                              k, n, TILES.index(tile), stream))
    return z


def apsp_f32(adj: torch.Tensor, steps: int | None = None,
             tile: int | None = None, grid: int | None = None
             ) -> torch.Tensor:
    """All-pairs shortest paths of a float32 CUDA matrix ``adj [n, n]``
    (edge weights >= 0, ``inf`` = no edge) in one cooperative launch: at
    most ``steps`` squarings (default ``ceil(log2 n)``), stopping after the
    first that changes nothing, which changes no bit of the result.
    ``grid`` (default ``persistent_grid``) larger than the card holds at
    once is refused and raises.  ``last_squarings()`` then holds the
    squarings run."""
    global _last_squarings
    _check("apsp_f32", torch.float32, adj)
    n = adj.shape[0]
    if adj.shape[1] != n or not 1 <= n < 1 << 21:
        raise ValueError(f"apsp_f32 takes a square matrix, got "
                         f"{tuple(adj.shape)}")
    steps = apsp_steps(n) if steps is None else int(steps)
    if steps < 1:
        raise ValueError(f"apsp_f32 runs at least one squaring, got {steps}")
    dev = adj.device
    tile = tile_for(n, n, _sms(dev)) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"apsp_f32 tile {tile} is not one of {TILES}")
    grid = persistent_grid("apsp_f32", tile, n, dev) if grid is None \
        else grid
    lib = _library()
    out = torch.empty_like(adj)
    tmp = torch.empty_like(adj)
    # the barrier's counter, the squarings run, one flag a squaring
    ws = torch.zeros(2 + steps, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launched("apsp_f32", lib.apsp_f32(adj.data_ptr(), out.data_ptr(),
                                       tmp.data_ptr(), ws.data_ptr(), n,
                                       steps, TILES.index(tile), grid,
                                       stream))
    _last_squarings = ws[1]
    return out
