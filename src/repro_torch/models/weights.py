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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve
from .encdec import EncDecLM, n_enc_layers
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


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by dotted path; a tuple or list's items by their index."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unstack(name: str, t: torch.Tensor, cfg: ModelConfig):
    """(port name, tensor) pairs of one leaf: a stacked layer leaf split
    into its layers, any other leaf as it is."""
    stacks = {"layers": cfg.n_layers, "dec_layers": cfg.n_layers,
              "enc_layers": n_enc_layers(cfg)}
    stack, _, rest = name.partition(".")
    if stack in stacks:
        n = stacks[stack]
        if t.shape[0] != n:
            raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                             f"{n} layers")
        return [(f"{stack}.{i}.{rest}", t[i]) for i in range(n)]
    if name.startswith("period."):
        slot, rest = name[len("period."):].split(".", 1)
        n_p = cfg.n_layers // cfg.attn_every
        if t.shape[0] != n_p:
            raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                             f"{n_p} periods")
        return [(f"layers.{p * cfg.attn_every + int(slot)}.{rest}", t[p])
                for p in range(n_p)]
    return [(name, t)]


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> torch.nn.Module:
    """The reference's param tree of any family's LM as the port's model
    on ``device`` (CUDA unless asked for the CPU).  Every leaf must match a
    parameter by name, shape and dtype, and every parameter must be
    covered."""
    if cfg.family not in _MODELS:
        raise ValueError(f"params_from_jax: unknown family {cfg.family!r}")
    dev = resolve(device)
    state = {}
    for name, arr in _flatten(tree).items():
        state.update(_unstack(name, to_torch(arr), cfg))
    model = _MODELS[cfg.family](cfg, dev)
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(f"param tree does not match the model: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(own[name].shape) \
                or t.dtype != own[name].dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} != "
                             f"{tuple(own[name].shape)} {own[name].dtype}")
        own[name].copy_(t)
    return model
