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
of ``like`` in place, on their device and in their dtype.
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
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=ckpt_dir)
    try:
        flat = _flatten(tree)
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
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Load the checkpoint at ``step`` (the latest by default) into the
    tensors of ``like`` in place; returns (``like``, the manifest's
    ``extra``).  ``shardings`` re-shards onto a device mesh in the
    reference; one device has none, so only ``None`` is taken."""
    if shardings is not None:
        raise ValueError("restore(shardings=...): re-sharding onto a device "
                         "mesh is not ported; on one device a checkpoint "
                         "loads as it is")
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for key, ts, stacked in _leaves(like):
            arr = arrays[key]
            want = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint {arr.shape} vs target "
                                 f"{want}")
            for t, row in zip(ts, arr if stacked else (arr,)):
                t.copy_(torch.from_numpy(np.array(row)))
    return like, manifest["extra"]
