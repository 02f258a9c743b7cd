"""Decoder-only transformer LM, dense and MoE families: port of
``src/repro/models/transformer.py``.

Three entry points, as in the reference's serving split:

  * ``lm_apply``       — full-sequence forward -> logits
  * ``lm_prefill``     — forward that also fills a KV cache
  * ``lm_decode_step`` — one-token step against the cache

The reference stacks the layers into [L, ...] pytrees for ``lax.scan``;
the port keeps one ``Layer`` module per layer in an ``nn.ModuleList`` and
loops over them.  The KV cache keeps the reference's layout,
``{"k", "v": [L, B, Smax, KV, Dh], "len": [B] int32}``, but prefill and
decode write it in place and return it (the reference returns new arrays):
a serving loop owns its cache.  A layer holds ``moe`` (``models/moe.py``)
in place of ``mlp`` where the reference's ``layer_init`` puts one: every
layer of a ``moe``-family config, and every layer of any config with
experts and ``moe_every == 1``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve
from . import attention as attn_mod
from .layers import (MLP, Attention, Embed, ModelConfig, RMSNorm, Unembed,
                     apply_rope, embed, fill_normal, mlp, out_project,
                     qkv_project, rmsnorm, unembed)
from .moe import MoE, fill_moe, moe_apply

Cache = Dict[str, torch.Tensor]


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype, device)
        if cfg.family == "moe" or (cfg.is_moe_arch and cfg.moe_every == 1):
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class DenseLM(nn.Module):
    """Parameters of the dense or MoE LM, named as the reference's param
    tree."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(Layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.unembed = Unembed(cfg, device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@torch.no_grad()
def lm_init(gen: torch.Generator, cfg: ModelConfig) -> DenseLM:
    """Random weights with the reference's distributions (dense weights
    N(0, 1/d_in), experts as ``moe.fill_moe``, embedding and unembedding
    N(0, 0.02^2), norm scales 1), drawn on the generator's device.  The
    numbers differ from ``jax.random``'s; the parity tests carry the
    reference's weights across with ``params_from_jax``."""
    dev = gen.device
    model = DenseLM(cfg, dev)
    for layer in model.layers:
        for norm in (layer.ln1, layer.ln2):
            norm.scale.fill_(1)
        fill_attention(layer.attn, gen, cfg)
        fill_ffn(layer, gen)
    fill_normal(model.embed.tok, gen, 0.02)
    model.final_norm.scale.fill_(1)
    if not cfg.tie_embeddings:
        fill_normal(model.unembed.w, gen, 0.02)
    return model


def fill_attention(a: Attention, gen: torch.Generator,
                   cfg: ModelConfig) -> None:
    """Projections N(0, 1/d_in), the q/k norm scales 1."""
    for w in (a.wq, a.wk, a.wv, a.wo):
        fill_normal(w, gen)
    if cfg.qk_norm:
        a.q_norm.scale.fill_(1)
        a.k_norm.scale.fill_(1)


def fill_ffn(layer: nn.Module, gen: torch.Generator) -> None:
    """A layer's ``moe`` or ``mlp`` with the reference's distributions."""
    if hasattr(layer, "moe"):
        fill_moe(layer.moe, gen)
    else:
        for w in (layer.mlp.wi, layer.mlp.wg, layer.mlp.wo):
            fill_normal(w, gen)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


def ffn(layer: nn.Module, h: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """The layer's feed-forward on the normed h: (out, aux loss), the aux
    loss a float32 scalar tensor for MoE and the number 0.0 for a dense
    MLP (no device tensor a layer on the serving path, which drops it)."""
    if hasattr(layer, "moe"):
        return moe_apply(layer.moe, h, cfg)
    return mlp(layer.mlp, h), 0.0


def _positions(s: int, offset, device) -> torch.Tensor:
    """[1, S] positions from an int offset, [B, S] from a [B] tensor."""
    if isinstance(offset, torch.Tensor):
        offset = offset.reshape(-1, 1)
    return torch.arange(s, device=device)[None, :] + offset


def _rope(cfg: ModelConfig, q, k, offset):
    pos = _positions(q.shape[1], offset, q.device)
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta))


def layer_apply(p: Layer, x: torch.Tensor, cfg: ModelConfig, *,
                backend: str = "chunked"
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Returns (x_out, aux loss)."""
    h = rmsnorm(p.ln1, x)
    q, k, v = qkv_project(p.attn, h, cfg)
    q, k = _rope(cfg, q, k, 0)
    o = attn_mod.attention(q, k, v, causal=True, backend=backend)
    x = x + out_project(p.attn, o)
    m, aux = ffn(p, rmsnorm(p.ln2, x), cfg)
    return x + m, aux


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def lm_apply(params: DenseLM, batch: Dict[str, torch.Tensor],
             cfg: ModelConfig, *,
             backend: str = "chunked") -> Dict[str, torch.Tensor]:
    """``batch["tokens"]`` [B,S] -> ``hidden`` [B,S,D], ``aux_loss`` (the
    layers' sum over ``n_layers``; 0 for a dense model) and ``logits``
    [B,S,V] float32."""
    x = embed(params.embed, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        x, a = layer_apply(layer, x, cfg, backend=backend)
        aux = aux + a
    x = rmsnorm(params.final_norm, x)
    return {"hidden": x, "aux_loss": aux / cfg.n_layers,
            "logits": unembed(params.unembed, params.embed, x, cfg)}


# ---------------------------------------------------------------------------
# serve: KV cache prefill / decode
# ---------------------------------------------------------------------------


def lm_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                  device=None) -> Cache:
    dev = resolve(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """Write ``new`` [B,1,KV,Dh] into ``cache`` [B,Smax,KV,Dh] at row b's
    position ``pos[b]``, in place.  A position at or past Smax writes
    nothing, as the reference's scatter drops an out-of-range update (an
    idle serving slot keeps decoding and its length keeps growing).  Done
    with a clamped index and a select, so nothing waits for the device."""
    b, smax = cache.shape[0], cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    pos = pos.to(torch.int64)
    idx = pos.clamp(0, smax - 1)
    keep = (pos >= smax).reshape(b, 1, 1)
    cache[rows, idx] = torch.where(keep, cache[rows, idx],
                                   new[:, 0].to(cache.dtype))


def _cached_layer(p: Layer, kc: torch.Tensor, vc: torch.Tensor,
                  x: torch.Tensor, cfg: ModelConfig, offset,
                  cache_len: Optional[torch.Tensor], *,
                  backend: str) -> torch.Tensor:
    """One layer of prefill (``offset`` an int: writes the cache at
    [offset, offset + S)) or decode (``offset`` a [B] tensor: writes each
    row at its own position, then attends over the cache).  ``kc``/``vc``
    are this layer's [B, Smax, KV, Dh] views of the cache, updated in
    place.  The feed-forward's aux loss is dropped, as the reference's
    is."""
    h = rmsnorm(p.ln1, x)
    q, k, v = qkv_project(p.attn, h, cfg)
    q, k = _rope(cfg, q, k, offset)
    s = x.shape[1]
    if isinstance(offset, int):
        if offset < 0 or offset + s > kc.shape[1]:
            raise ValueError(f"prefill of {s} tokens at {offset} does not "
                             f"fit a cache of {kc.shape[1]}")
        kc[:, offset:offset + s] = k.to(kc.dtype)
        vc[:, offset:offset + s] = v.to(vc.dtype)
    else:
        _scatter_kv(kc, k, offset)
        _scatter_kv(vc, v, offset)
    if s == 1:
        o = attn_mod.decode_attention(q, kc, vc, cache_len)
    else:
        o = attn_mod.attention(q, k, v, causal=True, q_offset=offset,
                               backend=backend)
    x = x + out_project(p.attn, o)
    return x + ffn(p, rmsnorm(p.ln2, x), cfg)[0]


@torch.no_grad()
def lm_prefill(params: DenseLM, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, cache: Cache, *,
               backend: str = "chunked") -> Tuple[torch.Tensor, Cache]:
    """Full-prompt forward; fills cache[:, :, :S] in place; returns the
    last position's logits [B, 1, V] float32 and the cache with
    ``len = S``."""
    x = embed(params.embed, batch["tokens"])
    s = x.shape[1]
    for i, layer in enumerate(params.layers):
        x = _cached_layer(layer, cache["k"][i], cache["v"][i], x, cfg, 0,
                          None, backend=backend)
    x = rmsnorm(params.final_norm, x[:, -1:])
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": torch.full_like(cache["len"], s)}


@torch.no_grad()
def lm_decode_step(params: DenseLM, tokens: torch.Tensor, cache: Cache,
                   cfg: ModelConfig, *,
                   backend: str = "kernel") -> Tuple[torch.Tensor, Cache]:
    """tokens [B,1]; each row's RoPE position and cache slot is its
    ``len``.  Returns logits [B, 1, V] float32 and the cache (written in
    place) with ``len + 1``.  The step attends over the cache by its
    one-token path (``decode_attention``) whatever ``backend`` names, the
    prefill's attention, which a serving loop passes to every family.  The
    reference's ``batch_extra`` (embeddings in place of tokens) is not
    ported yet (the vlm family, ROADMAP queue 1 item 11)."""
    x = embed(params.embed, tokens)
    pos = cache["len"]                                           # [B]
    for i, layer in enumerate(params.layers):
        x = _cached_layer(layer, cache["k"][i], cache["v"][i], x, cfg, pos,
                          pos + 1, backend="naive")
    x = rmsnorm(params.final_norm, x)
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": cache["len"] + 1}
