"""Jamba-style hybrid LM: Mamba and attention layers interleaved, MoE on
every ``moe_every``-th layer.  Port of ``src/repro/models/hybrid.py``.

The layer sequence has period ``attn_every``: the last layer of each
period is an attention layer, the others are Mamba blocks
(``models/ssm.py``); a layer's feed-forward is ``moe`` (``models/moe.py``)
where ``cfg.moe_layer`` says so and ``mlp`` elsewhere.  The reference
stacks each period slot's parameters over the periods ([P, ...]) for
``lax.scan``; the port keeps one ``HybridLayer`` per layer in the
reference's order (slot i of period p is layer ``p * attn_every + i``).

Decode carries both cache kinds, with the reference's leaves: ``k``/``v``
[P, B, Smax, KV, Dh] for the one attention layer of each period,
``ssm.slot{i}.h`` [P, B, Di, N] and ``ssm.slot{i}.conv`` [P, B, K-1, Di]
(float32) for the Mamba slots, and ``len`` [B].  Prefill and decode write
them in place and return the cache, as ``transformer.lm_prefill`` does.

``backend`` picks both plain-or-kernel choices at once
(``ssm.SCAN_BACKENDS``):
``"kernel"`` runs the attention layers' prefill through the flash kernel
and every Mamba block's scan through the fused scan kernel (the CUDA
kernels for CUDA tensors, their plain versions on the CPU); ``"chunked"``
runs the chunked attention and the chunked scan wherever the tensors are.
Decode attends over the cache by its one-token path either way.

On a mesh the cache may hold the rank's shard (``cache_specs_tree``): the
prefill, which runs FSDP with no sequence split (the reference's hybrid
prefill constrains no activation), writes every leaf in that layout, and
a decode step with ``cfg.fsdp`` False runs tensor parallel through the
attention, Mamba and MoE layers (``sharding/tp.py``).  The train
forward takes the reference's ``activation_hint`` at every layer
boundary: the sequence split where the global batch leaves ``"model"``
idle (``hybrid_apply``).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from ..device import resolve
from ..sharding import tp
from .layers import (MLP, Attention, Embed, ModelConfig, RMSNorm, Unembed,
                     embed, fill_normal, remat_call, rmsnorm, unembed)
from .moe import MoE
from .ssm import SCAN_BACKENDS, Mamba, fill_mamba, mamba_mix
from .transformer import (_cached_layer, ffn, fill_attention, fill_ffn,
                          layer_apply)

Cache = Dict[str, object]


def _is_attn(cfg: ModelConfig, layer: int) -> bool:
    return layer % cfg.attn_every == cfg.attn_every - 1


def n_periods(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


class HybridLayer(nn.Module):
    """ln1, ``attn`` or ``mamba``, ln2, ``moe`` or ``mlp``."""

    def __init__(self, cfg: ModelConfig, layer: int, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype, device)
        if _is_attn(cfg, layer):
            self.attn = Attention(cfg, device)
        else:
            self.mamba = Mamba(cfg, device)
        if cfg.moe_layer(layer):
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class HybridLM(nn.Module):
    """Parameters of the hybrid LM; ``layers.{l}`` holds the reference's
    ``period[l % attn_every]`` at period ``l // attn_every``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        n_periods(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(HybridLayer(cfg, i, device)
                                    for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.unembed = Unembed(cfg, device)


@torch.no_grad()
def hybrid_init(gen: torch.Generator, cfg: ModelConfig) -> HybridLM:
    """Random weights with the reference's distributions (attention and
    MLP weights N(0, 1/d_in), Mamba blocks as ``ssm.fill_mamba``, experts
    as ``moe.fill_moe``, embedding and unembedding N(0, 0.02^2), norm
    scales 1), drawn on the generator's device.  The numbers differ from
    ``jax.random``'s; the parity tests carry the reference's weights
    across with ``params_from_jax``."""
    model = HybridLM(cfg, gen.device)
    for layer in model.layers:
        layer.ln1.scale.fill_(1)
        layer.ln2.scale.fill_(1)
        if hasattr(layer, "attn"):
            fill_attention(layer.attn, gen, cfg)
        else:
            fill_mamba(layer.mamba, gen, cfg)
        fill_ffn(layer, gen)
    fill_normal(model.embed.tok, gen, 0.02)
    model.final_norm.scale.fill_(1)
    if not cfg.tie_embeddings:
        fill_normal(model.unembed.w, gen, 0.02)
    return model


def _check_backend(backend: str) -> None:
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"hybrid backend {backend!r}: the hybrid family "
                         f"takes {SCAN_BACKENDS}")


def _zero_state(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                       dtype=torch.float32, device=x.device)


def _mamba_layer(layer: HybridLayer, x: torch.Tensor, cfg: ModelConfig,
                 h0: torch.Tensor, conv=None, *, backend: str,
                 sp: bool = False):
    """A Mamba layer from state (h0, conv; ``ssm.mamba_mix``), then its
    feed-forward: (x_out, aux loss, the block's new state)."""
    y, state = mamba_mix(layer.mamba, rmsnorm(layer.ln1, x), cfg, h0, conv,
                         backend=backend, sp=sp)
    x = x + y
    m, aux = ffn(layer, rmsnorm(layer.ln2, x), cfg)
    return x + m, aux, state


def _layer(layer: HybridLayer, x: torch.Tensor, cfg: ModelConfig,
           backend: str, sp: bool):
    """One layer of the full-sequence forward: (x_out, aux loss); ``sp``:
    x holds this rank's positions under the sequence split."""
    if hasattr(layer, "attn"):
        return layer_apply(layer, x, cfg, backend=backend, sp=sp)
    return _mamba_layer(layer, x, cfg, _zero_state(cfg, x),
                        backend=backend, sp=sp)[:2]


def hybrid_apply(params: HybridLM, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, backend: str = "chunked",
                 remat: bool = True, logits: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """``batch["tokens"]`` [B,S] -> ``hidden`` [B,S,D], ``aux_loss`` (the
    MoE layers' sum over ``n_layers``) and, unless ``logits=False``,
    ``logits`` [B,S,V] float32.  Differentiable through
    ``backend="chunked"`` (the reference's default and its training path;
    the CUDA kernels have no backward and raise under autograd).
    ``remat`` rematerialises each layer, not each period, in the backward
    pass (``layers.remat_call``), as the reference does: a whole period's
    chunked scans would stay live otherwise.  Under the sequence split
    (``tp.sequence_parallel``) each rank runs and returns its S/m
    positions of its rows: the attention layers gather K/V along S, the
    Mamba layers pass the scan's state and the convolution's context
    along the ranks, and the MoE layers route the rank's tokens."""
    _check_backend(backend)
    tokens = batch["tokens"]
    sp = tp.sequence_parallel(cfg, tokens.shape[1])
    x = embed(params.embed, tp.chunk(tokens, 1) if sp else tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        x, a = remat_call(functools.partial(_layer, layer, cfg=cfg,
                                            backend=backend, sp=sp), x,
                          remat=remat)
        aux = aux + a
    x = rmsnorm(params.final_norm, x)
    out = {"hidden": x, "aux_loss": aux / cfg.n_layers}
    if logits:
        out["logits"] = unembed(params.unembed, params.embed, x, cfg)
    return out


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def hybrid_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                      device=None) -> Cache:
    dev = resolve(device)
    np_ = n_periods(cfg)
    kv = (np_, batch_size, max_len, cfg.n_kv, cfg.d_head)
    f32 = torch.float32
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "ssm": {f"slot{i}": {
            "h": torch.zeros((np_, batch_size, cfg.d_inner, cfg.ssm_state),
                             dtype=f32, device=dev),
            "conv": torch.zeros((np_, batch_size, cfg.ssm_conv - 1,
                                 cfg.d_inner), dtype=f32, device=dev)}
            for i in range(cfg.attn_every) if not _is_attn(cfg, i)},
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }


def _layers(params: HybridLM, cfg: ModelConfig):
    """(layer, period, slot) in the reference's order."""
    for li, layer in enumerate(params.layers):
        yield (layer,) + divmod(li, cfg.attn_every)


def _store(slot: Cache, p: int, state: Dict[str, torch.Tensor]) -> None:
    """A Mamba block's new (h, conv) into its slot's cache at period p, in
    the cache's layout."""
    for k in ("h", "conv"):
        slot[k][p].copy_(tp.to_cache(state[k], slot[k][p]))


@torch.no_grad()
def hybrid_prefill(params: HybridLM, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, cache: Cache, *,
                   backend: str = "kernel") -> Tuple[torch.Tensor, Cache]:
    """The prompt from a zero state: fills the attention layers' cache at
    [0, S) and each Mamba layer's final (h, conv), in place; returns the
    last position's logits [B,1,V] float32 and the cache with
    ``len = S``."""
    _check_backend(backend)
    x = embed(params.embed, batch["tokens"], cfg)
    s = x.shape[1]
    h0 = _zero_state(cfg, x)
    for layer, p, i in _layers(params, cfg):
        if hasattr(layer, "attn"):
            x = _cached_layer(layer, cache["k"][p], cache["v"][p], x, cfg, 0,
                              None, backend=backend)
        else:
            x, _, state = _mamba_layer(layer, x, cfg, h0, backend=backend)
            _store(cache["ssm"][f"slot{i}"], p, state)
    x = rmsnorm(params.final_norm, x[:, -1:])
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "ssm": cache["ssm"],
                    "len": torch.full_like(cache["len"], s)}


@torch.no_grad()
def hybrid_decode_step(params: HybridLM, tokens: torch.Tensor, cache: Cache,
                       cfg: ModelConfig, *, backend: str = "kernel"
                       ) -> Tuple[torch.Tensor, Cache]:
    """tokens [B,1]; each row's RoPE position and KV slot is its ``len``.
    The Mamba layers step their state by the scan ``backend`` names at
    S = 1, as ``ssm.mamba_decode_step`` does; the attention layers attend
    over the cache by the one-token path.  Returns logits [B,1,V] float32
    and the cache (written in place) with ``len + 1``."""
    _check_backend(backend)
    x = embed(params.embed, tokens, cfg)
    pos = tp.local_rows(cache["len"], x.shape[0])
    for layer, p, i in _layers(params, cfg):
        if hasattr(layer, "attn"):
            x = _cached_layer(layer, cache["k"][p], cache["v"][p], x, cfg,
                              pos, pos + 1, backend="naive")
        else:
            slot = cache["ssm"][f"slot{i}"]
            x, _, state = _mamba_layer(layer, x, cfg, slot["h"][p],
                                       slot["conv"][p], backend=backend)
            _store(slot, p, state)
    x = rmsnorm(params.final_norm, x)
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "ssm": cache["ssm"],
                    "len": cache["len"] + 1}
