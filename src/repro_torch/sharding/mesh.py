"""Device meshes and the ambient mesh: the part of
``src/repro/launch/mesh.py`` the models and the engine use, and
``jax.set_mesh`` / ``jax.sharding.get_abstract_mesh`` as the reference's
models use them.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the default
process group, whose world must be the mesh's size.  This module never
starts a group: the caller sets it up first (``torchrun``'s environment, a
``torch.multiprocessing`` spawn with ``init_method="file://..."``, or the
fake group of ``launch/dryrun.py``, which lets one process stand for rank
0 of a 256- or 512-chip mesh on fake tensors) and tears it down.

``use_mesh(mesh)`` makes ``mesh`` the ambient mesh for the code under it
(a context variable, ``None`` outside): the models' ``fsdp_params``,
``moe_apply``'s expert-parallel branch and the tensor-parallel layers
(``sharding/tp.py``) read it with ``current_mesh()``.
``use_mesh(mesh, global_batch=n)`` also names the global batch of the
step run under it, which rank-local tensors do not tell: the reference's
``activation_hint`` picks the sequence split by it
(``tp.sequence_parallel``).  The production meshes are in
``launch/mesh.py``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Sequence

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                          default=None)
_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_global_batch", default=None)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, on ``device_type`` (``None``: ``"cuda"``; the CPU tests pass
    ``"cpu"``).  Raises when no group is set up or its world is not
    ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh{shape}: no default process group; set one up "
            "first (torchrun, a spawn with init_method='file://...', or "
            "the dry run's fake group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh{shape}: the default group has "
                           f"{dist.get_world_size()} ranks, the mesh {n}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only stand-in
    with ``axis_names`` and ``devices`` (an array of the mesh's shape) or
    ``axis_sizes``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is None:
        sizes = mesh.devices.shape
    return dict(zip(mesh.axis_names, sizes))


def mesh_chips(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


@contextlib.contextmanager
def use_mesh(mesh, global_batch: Optional[int] = None) -> Iterator:
    """``mesh`` is the ambient mesh inside the block, and
    ``global_batch`` (``None``: not given) the global batch of the step
    run in it."""
    token = _CURRENT.set(mesh)
    btoken = _BATCH.set(global_batch)
    try:
        yield mesh
    finally:
        _BATCH.reset(btoken)
        _CURRENT.reset(token)


def current_mesh():
    """The ambient mesh, or ``None`` outside ``use_mesh``."""
    return _CURRENT.get()


def current_global_batch() -> Optional[int]:
    """The global batch ``use_mesh`` was given, or ``None``."""
    return _BATCH.get()
