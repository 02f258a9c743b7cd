"""Atomic checkpoint save and restore: port of
``src/repro/checkpoint/ckpt.py``, in the reference's layout, so that a
checkpoint written by either package loads in the other.

Layout: ``<dir>/step_<N:08d>/`` holding ``arrays.npz`` (every leaf of the
tree by its path) and ``manifest.json`` (step, sorted keys, dtypes, shapes,
``extra``).  A save writes to ``.tmp-...`` and then ``os.replace``s it, so
a crashed writer never corrupts the latest checkpoint (``latest_step``
reads only directories with a complete manifest).  bf16 is widened to
float32 (numpy has no bf16; narrowing it back is exact).

Paths follow the reference's flattening of its pytrees: dict keys sorted,
sequence items by index, a NamedTuple's fields as ``.<field>``, joined by
``/``.  A port model (any family's LM) stands for the reference's param
tree: its leaves come from ``models/weights.py::leaf_map``, each layer
stack stacked along its leading axis, so ``(params, opt_state)`` saves as
``0/layers/attn/wq``, ``1/.step``, ``1/.mu/layers/attn/wq``, ... exactly
as the reference's does.  ``restore`` copies every leaf into the tensors
of ``like`` in place, on their device and in their dtype; with
``shardings`` it makes each leaf a DTensor on a mesh instead, its local
shard this rank's slice of the saved array.  The layout on disk is the
same either way, so a checkpoint written by either package, on one device
or from a mesh, restores onto a mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.weights import leaf_map, to_numpy, tree_order

_SEP = "/"


def _leaves(tree: Any, prefix: str = ""
            ) -> Iterator[Tuple[str, Tuple[torch.Tensor, ...], bool]]:
    """(path, the tensors of the leaf, stacked) of every leaf of ``tree``
    in the reference's order: a stacked leaf's tensors are its rows."""
    if isinstance(tree, torch.nn.Module):
        for key, leaf in leaf_map(tree, tree.cfg).items():
            yield prefix + key, leaf.params, leaf.stacked
    elif hasattr(tree, "_fields"):                  # a NamedTuple
        for field in tree._fields:
            yield from _leaves(getattr(tree, field),
                               f"{prefix}.{field}{_SEP}")
    elif isinstance(tree, dict):
        for key in sorted(tree, key=lambda k: tree_order(str(k))):
            yield from _leaves(tree[key], f"{prefix}{key}{_SEP}")
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{prefix}{i}{_SEP}")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-len(_SEP)], (tree,), False
    else:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a "
                        f"{type(tree).__name__}")


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: np.stack([to_numpy(t) for t in ts]) if stacked
            else to_numpy(ts[0]) for key, ts, stacked in _leaves(tree)}


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as step ``step``.  A tree of plain tensors is
    written by the rank that calls ``save``.  A tree that holds a DTensor
    is gathered whole, so every rank of the mesh calls ``save``; rank 0
    writes, and every rank returns once it has."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    sharded = any(hasattr(t, "full_tensor")               # a DTensor
                  for _, ts, _ in _leaves(tree) for t in ts)
    flat = _flatten(tree)
    if not sharded:
        _write(ckpt_dir, final, step, flat, extra)
        return final
    import torch.distributed as dist
    if dist.get_rank() == 0:
        _write(ckpt_dir, final, step, flat, extra)
    dist.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int,
           flat: Dict[str, np.ndarray], extra) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _sharded(arr: np.ndarray, like: torch.Tensor, sharding):
    """The saved ``arr`` as a DTensor placed by ``sharding`` (a
    ``sharding.rules.NamedSharding``; its spec may be a stacked leaf's,
    ``arr`` one row of it), in ``like``'s dtype and on its device."""
    from ..sharding.rules import from_local, local_slices
    mesh, spec = sharding
    local = np.ascontiguousarray(arr[local_slices(arr.shape, spec, mesh)])
    t = torch.from_numpy(local).to(dtype=like.dtype, device=like.device)
    return from_local(t, spec, mesh, arr.shape)


def _restore_sharded(arrays, tree: Any, shardings: Any, prefix: str = ""):
    """``tree`` with every leaf that has a sharding replaced by a DTensor
    of the saved array (a model's parameters in place); a subtree whose
    sharding is ``None`` is copied in place."""
    from ..sharding.rules import NamedSharding, P, row_spec
    if shardings is None:
        for key, ts, stacked in _leaves(tree, prefix):
            arr = arrays[key]
            for t, row in zip(ts, arr if stacked else (arr,)):
                t.copy_(torch.from_numpy(np.array(row)))
        return tree
    if isinstance(tree, torch.nn.Module):
        want = dict
    elif isinstance(tree, torch.Tensor):
        want = NamedSharding
    else:
        want = dict if isinstance(tree, dict) else (tuple, list)
    if not isinstance(shardings, want) or (
            isinstance(tree, (tuple, list)) and len(shardings) != len(tree)):
        raise ValueError(f"restore(shardings=...): {prefix or 'the tree'} "
                         f"takes a NamedSharding on a mesh or a tree of "
                         f"them like its own, not a "
                         f"{type(shardings).__name__}")
    if isinstance(tree, torch.nn.Module):
        for key, leaf in leaf_map(tree, tree.cfg).items():
            arr = arrays[prefix + key]
            sh = shardings[key]
            spec = P(*row_spec(sh.spec, leaf.stacked))
            for name, p, row in zip(leaf.names, leaf.params,
                                    arr if leaf.stacked else (arr,)):
                owner, _, attr = name.rpartition(".")
                mod = tree.get_submodule(owner) if owner else tree
                setattr(mod, attr, torch.nn.Parameter(
                    _sharded(row, p, NamedSharding(sh.mesh, spec)),
                    requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return _sharded(arrays[prefix[:-len(_SEP)]], tree, shardings)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_restore_sharded(
            arrays, getattr(tree, f), getattr(shardings, f),
            f"{prefix}.{f}{_SEP}") for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _restore_sharded(arrays, v, shardings[k],
                                    f"{prefix}{k}{_SEP}")
                for k, v in tree.items()}
    return type(tree)(_restore_sharded(arrays, v, sh, f"{prefix}{i}{_SEP}")
                      for i, (v, sh) in enumerate(zip(tree, shardings)))


@torch.no_grad()
def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Load the checkpoint at ``step`` (the latest by default) into the
    tensors of ``like`` in place; returns (``like``, the manifest's
    ``extra``).  ``shardings``, a tree of ``like``'s structure (a model's
    part keyed by leaf, as ``sharding.param_specs``) whose leaves are
    ``sharding.rules.NamedSharding``s (``sharding.rules.named``) or
    ``None``, re-shards onto a mesh: each such leaf comes back a DTensor
    whose local shard is this rank's slice of the saved array (a model's
    parameters are replaced in place), read from the host copy on every
    rank with no communication."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for key, ts, stacked in _leaves(like):
        got = tuple(manifest["shapes"][key])
        want = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
        if got != want:
            raise ValueError(f"{key}: checkpoint {got} vs target {want}")
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        like = _restore_sharded(arrays, like, shardings)
    return like, manifest["extra"]
