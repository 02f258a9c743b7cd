"""Carry the reference's weights into the port.

``params_from_jax(tree, cfg, device)`` takes the JAX package's param tree
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), layers stacked along a leading [L] axis (the hybrid family:
``period``, a tuple of ``attn_every`` slots each stacked over the periods
[P, ...]; the audio family: ``enc_layers`` over ``n_enc_layers or
n_layers`` and ``dec_layers`` over ``n_layers``), and returns the port's
model of ``cfg.family`` (``DenseLM`` for dense, moe and vlm, ``SSMLM``,
``HybridLM`` or ``EncDecLM``) holding the same numbers.  bf16 arrays arrive
as numpy arrays of the ``bfloat16`` extension type, which
``torch.from_numpy`` refuses; they are carried across bit for bit as int16
and viewed as ``torch.bfloat16``, so this module needs no ``ml_dtypes``.

``leaf_map(model, cfg)`` is the map between the two layouts, the
reference's stacked leaves onto the port's per-layer parameters;
``params_to_jax(model, cfg)`` goes the other way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from .encdec import EncDecLM
from .layers import ModelConfig
from .hybrid import HybridLM
from .mamba_lm import SSMLM
from .transformer import DenseLM

_MODELS = {"dense": DenseLM, "moe": DenseLM, "vlm": DenseLM, "ssm": SSMLM,
           "hybrid": HybridLM, "audio": EncDecLM}


def to_torch(a: Any) -> torch.Tensor:
    """A numpy array (float32, int, bool or 2-byte bfloat16) as a CPU
    tensor with the same bits (a copy: the tree's arrays may be
    read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Any, prefix: str = "", sep: str = ".") -> Dict[str, Any]:
    """Leaves by path joined with ``sep``; a tuple or list's items by
    their index."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            out.update(_flatten(v, f"{prefix}{k}{sep}", sep))
        else:
            out[f"{prefix}{k}"] = v
    return out


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's param tree in the port: the port
    parameters it stacks along its leading axis, in layer order (a layer
    stack's [L, ...], a hybrid period slot's [P, ...]) when ``stacked``,
    else its one parameter.  ``names`` are the parameters' names in the
    port's ``named_parameters``."""
    names: Tuple[str, ...]
    params: Tuple[torch.nn.Parameter, ...]
    stacked: bool

    @property
    def shape(self) -> Tuple[int, ...]:
        """The reference leaf's shape."""
        one = tuple(self.params[0].shape)
        return (len(self.params),) + one if self.stacked else one

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def rows(self, t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``t`` of the leaf's shape as one view a parameter, in the order
        of ``params``."""
        return tuple(t) if self.stacked else (t,)


def _leaf_key(name: str, cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """(the reference's key of the leaf, the index along its stack or
    None) of the port parameter ``name``: ``layers.3.attn.wq`` is
    ``layers/attn/wq`` at 3, a hybrid's ``layers.9.mamba.in_x`` is
    ``period/1/mamba/in_x`` at period 1 (``attn_every`` 8), ``embed.tok``
    is ``embed/tok``."""
    stack, _, rest = name.partition(".")
    if stack in ("layers", "enc_layers", "dec_layers"):
        i, _, rest = rest.partition(".")
        rest = rest.replace(".", "/")
        if cfg.family == "hybrid":
            p, slot = divmod(int(i), cfg.attn_every)
            return f"period/{slot}/{rest}", p
        return f"{stack}/{rest}", int(i)
    return name.replace(".", "/"), None


def tree_order(key: str):
    """Sort key of the reference's flattening: dict keys sorted, tuple
    items by index, one path component after another."""
    return tuple((0, int(c)) if c.isdigit() else (1, c)
                 for c in key.split("/"))


def leaf_map(model: torch.nn.Module, cfg: ModelConfig) -> Dict[str, Leaf]:
    """The reference's param-tree leaves of the port's ``model``, keyed
    as its checkpoint spells them (``layers/attn/wq``,
    ``period/1/moe/router``), in the order ``jax.tree_util`` flattens
    them.  The optimizer's unit is this leaf: its weight-decay rule reads
    the stacked rank, its gradient compression one scale a leaf, its
    global norm this order; the checkpoint stores each leaf stacked."""
    groups: Dict[str, list] = {}
    for name, p in model.named_parameters():
        key, i = _leaf_key(name, cfg)
        groups.setdefault(key, []).append((-1 if i is None else i, name, p))
    out = {}
    for key in sorted(groups, key=tree_order):
        items = sorted(groups[key], key=lambda item: item[0])
        out[key] = Leaf(names=tuple(n for _, n, _ in items),
                        params=tuple(p for _, _, p in items),
                        stacked=items[0][0] >= 0)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a numpy array on the host, bf16 widened
    to float32 (exact: narrowing it back gives the same bits); a DTensor
    as its whole value (``full_tensor``: a collective, so every rank of
    its mesh calls it)."""
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``a/b/c`` keys as nested dicts; a level whose keys are all digits
    (a hybrid's ``period``) as a tuple, as the reference's tree holds it."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for c in path:
            node = node.setdefault(c, {})
        node[last] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return tuple(node[str(i)] for i in range(len(node)))
        return node
    return fix(tree)


@torch.no_grad()
def params_to_jax(model: torch.nn.Module, cfg: ModelConfig
                  ) -> Dict[str, Any]:
    """``params_from_jax``'s inverse: the port's ``model`` as the
    reference's param tree, nested dicts (and the hybrid's ``period``
    tuple) of numpy arrays, each layer stack restacked along its leading
    axis.  bf16 parameters come out widened to float32 (numpy has no
    bf16); ``jnp.asarray(x, jnp.bfloat16)`` narrows them back exactly."""
    return _nest({key: np.stack([to_numpy(p) for p in leaf.params])
                  if leaf.stacked else to_numpy(leaf.params[0])
                  for key, leaf in leaf_map(model, cfg).items()})


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> torch.nn.Module:
    """The reference's param tree of any family's LM as the port's model
    on ``device`` (CUDA unless asked for the CPU).  Every leaf must match a
    leaf of ``leaf_map`` by key, stack depth, shape and dtype, and every
    parameter must be covered."""
    if cfg.family not in _MODELS:
        raise ValueError(f"params_from_jax: unknown family {cfg.family!r}")
    dev = resolve(device)
    flat = _flatten(tree, sep="/")
    model = _MODELS[cfg.family](cfg, dev)
    leaves = leaf_map(model, cfg)
    if set(leaves) != set(flat):
        raise ValueError(f"param tree does not match the model: missing "
                         f"{sorted(set(leaves) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(leaves))}")
    for key, leaf in leaves.items():
        t = to_torch(flat[key])
        if leaf.stacked and t.shape[:1] != leaf.shape[:1]:
            unit = "periods" if key.startswith("period/") else "layers"
            raise ValueError(f"{key}: leading axis {t.shape[0]} != "
                             f"{leaf.shape[0]} {unit}")
        if tuple(t.shape) != leaf.shape or t.dtype != leaf.params[0].dtype:
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype} != "
                             f"{leaf.shape} {leaf.params[0].dtype}")
        for p, row in zip(leaf.params, leaf.rows(t)):
            p.copy_(row)
    return model
