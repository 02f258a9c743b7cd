"""Model registry: family -> (init, apply, cache, prefill, decode) API.
Port of ``src/repro/models/registry.py`` for the dense, moe, ssm and hybrid
families.

``get_model(cfg)`` returns a ``ModelApi`` whose members close over the
config.  ``init(seed, device=)`` draws the weights from a ``torch.Generator``
seeded with ``seed`` on the device; it and ``init_cache`` run on CUDA
unless the caller asks for the CPU.  The other members run where their
tensors are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..device import resolve
from . import hybrid, mamba_lm, transformer
from .layers import ModelConfig

# family -> the ROADMAP item that ports it
_NOT_PORTED = {
    "audio": "ROADMAP queue 1 item 11, encdec",
    "vlm": "ROADMAP queue 1 item 11, vlm/M-RoPE",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]
    apply: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]


_TRANSFORMER = (transformer.lm_init, transformer.lm_apply,
                transformer.lm_init_cache, transformer.lm_prefill,
                transformer.lm_decode_step)
# family -> (init, apply, init_cache, prefill, decode_step)
_FAMILIES = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "ssm": (mamba_lm.ssm_lm_init, mamba_lm.ssm_lm_apply,
            mamba_lm.ssm_lm_init_cache, mamba_lm.ssm_lm_prefill,
            mamba_lm.ssm_lm_decode_step),
    "hybrid": (hybrid.hybrid_init, hybrid.hybrid_apply,
               hybrid.hybrid_init_cache, hybrid.hybrid_prefill,
               hybrid.hybrid_decode_step),
}


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"({_NOT_PORTED[cfg.family]})")
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "moe" and not cfg.is_moe_arch:
        raise ValueError(f"{cfg.name}: the moe family needs experts "
                         f"(n_experts {cfg.n_experts})")
    f_init, f_apply, f_cache, f_prefill, f_decode = _FAMILIES[cfg.family]
    return ModelApi(
        cfg=cfg,
        init=lambda seed=0, device=None: f_init(
            torch.Generator(device=resolve(device)).manual_seed(seed), cfg),
        apply=lambda params, batch, **kw: f_apply(params, batch, cfg, **kw),
        init_cache=lambda batch, max_len=0, device=None:
            f_cache(cfg, batch, max_len, device=device),
        prefill=lambda params, batch, cache, **kw: f_prefill(
            params, batch, cfg, cache, **kw),
        decode_step=lambda params, tokens, cache, **kw: f_decode(
            params, tokens, cache, cfg, **kw),
    )
