"""Falcon-Mamba-style attention-free LM: embed + N mamba blocks + head.
Port of ``src/repro/models/mamba_lm.py``.

Mamba1 layers have no separate MLP: the block is the layer.  The
reference scans over stacked [L, ...] layer params; the port keeps one
``SSMLayer`` per layer in an ``nn.ModuleList`` and loops over them (the
reference's ``fsdp_params`` runs in ``ssm.mamba_mix`` and its
``jax.checkpoint`` is ``remat``).  Its ``activation_hint`` at each layer
boundary of the train forward is the sequence split of ``ssm_lm_apply``
(``tp.sequence_parallel``: each rank runs its S/m positions, the scan's
state and the convolution's context passed along the ranks,
``ssm.mamba_mix``); its prefill constrains no activation.
On a mesh the cache may hold the rank's shard (``cache_specs_tree``):
prefill writes the state in that layout (``tp.to_cache``), and a decode
step with ``cfg.fsdp`` False runs tensor parallel (``ssm.py``).

The decode cache keeps the reference's layout, ``{"h": [L,B,Di,N] f32,
"conv": [L,B,K-1,Di] f32, "len": [B] int32}``; prefill and decode write
``h`` and ``conv`` in place and return the cache with the new ``len``, as
``transformer.lm_prefill`` does.  ``backend`` picks the scan
(``ssm.SCAN_BACKENDS``): ``"kernel"`` (the CUDA kernel for CUDA tensors,
its plain version on the CPU) or ``"chunked"`` (the plain chunked scan
wherever the tensors are).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from ..device import resolve
from ..sharding import tp
from .layers import (Embed, ModelConfig, RMSNorm, Unembed, embed,
                     fill_normal, remat_call, rmsnorm, unembed)
from .ssm import (Mamba, fill_mamba, mamba_apply, mamba_cache_init,
                  mamba_decode_step, mamba_mix)

Cache = Dict[str, torch.Tensor]


class SSMLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mamba = Mamba(cfg, device)


class SSMLM(nn.Module):
    """Parameters of the ssm LM, named as the reference's param tree."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(SSMLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.unembed = Unembed(cfg, device)


@torch.no_grad()
def ssm_lm_init(gen: torch.Generator, cfg: ModelConfig) -> SSMLM:
    """Random weights with the reference's distributions (``ssm.fill_mamba``
    for each block, embedding and unembedding N(0, 0.02^2), norm scales 1),
    drawn on the generator's device.  The numbers differ from
    ``jax.random``'s; the parity tests carry the reference's weights across
    with ``params_from_jax``."""
    model = SSMLM(cfg, gen.device)
    for layer in model.layers:
        layer.ln.scale.fill_(1)
        fill_mamba(layer.mamba, gen, cfg)
    fill_normal(model.embed.tok, gen, 0.02)
    model.final_norm.scale.fill_(1)
    if not cfg.tie_embeddings:
        fill_normal(model.unembed.w, gen, 0.02)
    return model


def _layer(layer: SSMLayer, x: torch.Tensor, cfg: ModelConfig,
           backend: str, sp: bool) -> torch.Tensor:
    return x + mamba_apply(layer.mamba, rmsnorm(layer.ln, x), cfg,
                           backend=backend, sp=sp)


def ssm_lm_apply(params: SSMLM, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, backend: str = "chunked",
                 remat: bool = True, logits: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """``batch["tokens"]`` [B,S] -> ``hidden`` [B,S,D], ``aux_loss`` (0)
    and, unless ``logits=False``, ``logits`` [B,S,V] float32.
    Differentiable through ``backend="chunked"`` (the reference's default
    and its training path; the CUDA scan has no backward and raises under
    autograd); ``remat`` rematerialises each layer in the backward pass
    (``layers.remat_call``).  Under the sequence split each rank runs
    and returns its S/m positions of its rows."""
    tokens = batch["tokens"]
    sp = tp.sequence_parallel(cfg, tokens.shape[1])
    x = embed(params.embed, tp.chunk(tokens, 1) if sp else tokens, cfg)
    for layer in params.layers:
        x = remat_call(functools.partial(_layer, layer, cfg=cfg,
                                         backend=backend, sp=sp), x,
                       remat=remat)
    x = rmsnorm(params.final_norm, x)
    out = {"hidden": x,
           "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
    if logits:
        out["logits"] = unembed(params.unembed, params.embed, x, cfg)
    return out


def ssm_lm_init_cache(cfg: ModelConfig, batch_size: int, max_len: int = 0,
                      device=None) -> Cache:
    """Zero state, one ``mamba_cache_init`` per layer stacked along [L];
    ``max_len`` is unused (the state does not grow)."""
    dev = resolve(device)
    per = mamba_cache_init(cfg, batch_size, device=dev)
    cache = {k: v.new_zeros((cfg.n_layers,) + v.shape) for k, v in
             per.items()}
    cache["len"] = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    return cache


def _store(cache: Cache, i: int, state: Dict[str, torch.Tensor]) -> None:
    """A block's new (h, conv) into layer i of the cache, in its layout."""
    for k in ("h", "conv"):
        cache[k][i].copy_(tp.to_cache(state[k], cache[k][i]))


@torch.no_grad()
def ssm_lm_prefill(params: SSMLM, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, cache: Cache, *,
                   backend: str = "kernel") -> Tuple[torch.Tensor, Cache]:
    """The prompt from a zero state; writes each layer's final (h, conv)
    into the cache in place; returns the last position's logits [B,1,V]
    float32 and the cache with ``len = S``."""
    x = embed(params.embed, batch["tokens"], cfg)
    s = x.shape[1]
    h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        y, state = mamba_mix(layer.mamba, rmsnorm(layer.ln, x), cfg, h0,
                             backend=backend)
        x = x + y
        _store(cache, i, state)
    x = rmsnorm(params.final_norm, x[:, -1:])
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"h": cache["h"], "conv": cache["conv"],
                    "len": torch.full_like(cache["len"], s)}


@torch.no_grad()
def ssm_lm_decode_step(params: SSMLM, tokens: torch.Tensor, cache: Cache,
                       cfg: ModelConfig, *, backend: str = "kernel"
                       ) -> Tuple[torch.Tensor, Cache]:
    """tokens [B,1] -> logits [B,1,V] float32 and the cache (written in
    place) with ``len + 1``."""
    x = embed(params.embed, tokens, cfg)
    for i, layer in enumerate(params.layers):
        y, state = mamba_decode_step(
            layer.mamba, rmsnorm(layer.ln, x),
            {"h": cache["h"][i], "conv": cache["conv"][i]}, cfg,
            backend=backend)
        x = x + y
        _store(cache, i, state)
    x = rmsnorm(params.final_norm, x)
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"h": cache["h"], "conv": cache["conv"],
                    "len": cache["len"] + 1}
