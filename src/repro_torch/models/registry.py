"""Model registry: family -> (init, apply, cache, prefill, decode) API.
Port of ``src/repro/models/registry.py`` for the dense family.

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
from . import transformer
from .layers import ModelConfig

# family -> the ROADMAP item that ports it
_NOT_PORTED = {
    "moe": "ROADMAP queue 1 item 11, moe",
    "ssm": "ROADMAP queue 1 item 11, ssm/mamba_lm",
    "hybrid": "ROADMAP queue 1 item 11, hybrid",
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


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"({_NOT_PORTED[cfg.family]})")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")
    return ModelApi(
        cfg=cfg,
        init=lambda seed=0, device=None: transformer.lm_init(
            torch.Generator(device=resolve(device)).manual_seed(seed), cfg),
        apply=lambda params, batch, **kw: transformer.lm_apply(
            params, batch, cfg, **kw),
        init_cache=lambda batch, max_len=0, device=None:
            transformer.lm_init_cache(cfg, batch, max_len, device=device),
        prefill=lambda params, batch, cache, **kw: transformer.lm_prefill(
            params, batch, cfg, cache, **kw),
        decode_step=lambda params, tokens, cache, **kw:
            transformer.lm_decode_step(params, tokens, cache, cfg, **kw),
    )
