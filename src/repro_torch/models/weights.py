"""Carry the reference's weights into the port.

``params_from_jax(tree, cfg, device)`` takes the JAX package's param tree
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), layers stacked along a leading [L] axis, and returns the port's
model of ``cfg.family`` (``DenseLM`` or ``SSMLM``) holding the same
numbers.  bf16 arrays arrive as numpy arrays
of the ``bfloat16`` extension type, which ``torch.from_numpy`` refuses;
they are carried across bit for bit as int16 and viewed as
``torch.bfloat16``, so this module needs no ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve
from .layers import ModelConfig
from .mamba_lm import SSMLM
from .transformer import DenseLM

_MODELS = {"dense": DenseLM, "ssm": SSMLM}


def to_torch(a: Any) -> torch.Tensor:
    """A numpy array (float32, int, bool or 2-byte bfloat16) as a CPU
    tensor with the same bits (a copy: the tree's arrays may be
    read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> torch.nn.Module:
    """The reference's param tree of a dense or ssm LM as the port's
    ``DenseLM`` or ``SSMLM`` on ``device`` (CUDA unless asked for the CPU).
    Every leaf must match a parameter by name, shape and dtype, and every
    parameter must be covered."""
    if cfg.family not in _MODELS:
        raise NotImplementedError(f"params_from_jax: family {cfg.family!r} "
                                  f"is not ported yet")
    dev = resolve(device)
    state = {}
    for name, arr in _flatten(tree).items():
        t = to_torch(arr)
        if name.startswith("layers."):
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                                 f"n_layers {cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{rest}"] = t[i]
        else:
            state[name] = t
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
