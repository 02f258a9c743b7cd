"""Model registry: family -> (init, apply, cache, prefill, decode) API.
Port of ``src/repro/models/registry.py`` for every family: dense, moe,
vlm (the transformer), ssm, hybrid and audio (the encoder-decoder).  The
input specs per (config, shape) (``train_input_specs`` and the others)
return tensors of the reference's shapes and dtypes (int32 tokens); the
dry run (``launch/dryrun.py``) calls them under fake mode, so nothing is
allocated.

``get_model(cfg)`` returns a ``ModelApi`` whose members close over the
config.  ``init(seed, device=)`` draws the weights from a ``torch.Generator``
seeded with ``seed`` on the device; it and ``init_cache`` run on CUDA
unless the caller asks for the CPU.  The other members run where their
tensors are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..device import resolve
from . import encdec, hybrid, mamba_lm, transformer
from .layers import ModelConfig


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
    "vlm": _TRANSFORMER,
    "ssm": (mamba_lm.ssm_lm_init, mamba_lm.ssm_lm_apply,
            mamba_lm.ssm_lm_init_cache, mamba_lm.ssm_lm_prefill,
            mamba_lm.ssm_lm_decode_step),
    "hybrid": (hybrid.hybrid_init, hybrid.hybrid_apply,
               hybrid.hybrid_init_cache, hybrid.hybrid_prefill,
               hybrid.hybrid_decode_step),
    "audio": (encdec.encdec_init, encdec.encdec_apply,
              encdec.encdec_init_cache, encdec.encdec_prefill,
              encdec.encdec_decode_step),
}


def get_model(cfg: ModelConfig) -> ModelApi:
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


# ---------------------------------------------------------------------------
# input specs per (config, shape)
# ---------------------------------------------------------------------------

I32 = torch.int32


def param_specs(cfg: ModelConfig, device="cpu") -> torch.nn.Module:
    """The model's parameters with their shapes and dtypes, not drawn
    (``torch.empty``): the counterpart of ``jax.eval_shape(init)``; fake
    tensors under fake mode."""
    from .weights import _MODELS
    return _MODELS[cfg.family](cfg, torch.device(device))


def _sds(shape, dtype, device="cpu") -> torch.Tensor:
    """An uninitialised tensor of ``shape`` and ``dtype``: the counterpart
    of ``jax.ShapeDtypeStruct`` (a fake tensor under fake mode)."""
    return torch.empty(shape, dtype=dtype, device=device)


def train_input_specs(cfg: ModelConfig, batch: int, seq: int,
                      device="cpu") -> Dict[str, torch.Tensor]:
    if cfg.family == "vlm" or cfg.frontend == "embed" and cfg.family != "audio":
        return {
            "embeds": _sds((batch, seq, cfg.d_model), cfg.dtype, device),
            "pos3": _sds((batch, seq, 3), I32, device),
            "labels": _sds((batch, seq), I32, device),
        }
    if cfg.family == "audio":
        return {
            "enc_embeds": _sds((batch, cfg.enc_seq, cfg.d_model), cfg.dtype,
                               device),
            "tokens": _sds((batch, seq), I32, device),
            "labels": _sds((batch, seq), I32, device),
        }
    return {
        "tokens": _sds((batch, seq), I32, device),
        "labels": _sds((batch, seq), I32, device),
    }


def prefill_input_specs(cfg: ModelConfig, batch: int, seq: int,
                        device="cpu"):
    specs = train_input_specs(cfg, batch, seq, device)
    specs.pop("labels")
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, device="cpu"):
    """The decode cache of ``init_cache`` (fake tensors under fake mode)."""
    return get_model(cfg).init_cache(batch, max_len, device=device)


def decode_input_specs(cfg: ModelConfig, batch: int, device="cpu"):
    if cfg.family == "vlm":
        return {"embeds": _sds((batch, 1, cfg.d_model), cfg.dtype, device),
                "pos3": _sds((batch, 1, 3), I32, device)}
    return {"tokens": _sds((batch, 1), I32, device)}
