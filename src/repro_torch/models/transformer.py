"""Decoder-only transformer LM, dense, MoE and vlm families: port of
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
a serving loop owns its cache.  Input is either ``tokens`` [B,S] or
``embeds`` [B,S,D] (the vlm family's stub frontend: pre-merged text and
vision embeddings, cast to the config's dtype), with ``pos3`` [B,S,3]
(t, h, w) for M-RoPE when the config sets ``mrope``; without ``pos3`` the
positions are the plain RoPE's.  A layer holds ``moe`` (``models/moe.py``)
in place of ``mlp`` where the reference's ``layer_init`` puts one: every
layer of a ``moe``-family config, and every layer of any config with
experts and ``moe_every == 1``.

On a mesh (``sharding.mesh.use_mesh``) the layers run in the reference's
serving layouts (``sharding/tp.py``): a decode step with ``cfg.fsdp``
False is Megatron tensor parallel over a cache laid out by
``cache_specs_tree`` (Dh over ``"model"``); a prefill whose global batch
leaves ``"model"`` idle (``tp.sequence_parallel``, the rule of the
reference's ``activation_hint`` in its ``lm_prefill``) runs each rank's
S/m positions with the weights gathered at use and K/V gathered along S
once a layer, and so does ``lm_apply``, the train forward, by the same
rule (its ``activation_hint`` at every layer boundary).  Every other
step gathers the weights at use (FSDP).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve
from . import attention as attn_mod
from ..sharding import tp
from ..sharding.rules import fsdp_params
from .layers import (MLP, Attention, Embed, ModelConfig, RMSNorm, Unembed,
                     apply_mrope, apply_rope, embed, fill_normal, mlp,
                     out_project, qkv_project, remat_call, rmsnorm, unembed)
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
    """Parameters of the dense, MoE or vlm LM, named as the reference's
    param tree."""

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
    return mlp(fsdp_params(layer.mlp, cfg), h), 0.0


def _positions(s: int, offset, device) -> torch.Tensor:
    """[1, S] positions from an int offset, [B, S] from a [B] tensor."""
    if isinstance(offset, torch.Tensor):
        offset = offset.reshape(-1, 1)
    return torch.arange(s, device=device)[None, :] + offset


def _rope(cfg: ModelConfig, q, k, offset, pos3=None):
    """M-RoPE at ``pos3`` [B,S,3] when the config sets ``mrope`` and the
    batch carries one; otherwise RoPE at ``offset`` + 0..S-1."""
    if cfg.mrope and pos3 is not None:
        return (apply_mrope(q, pos3, cfg.rope_theta),
                apply_mrope(k, pos3, cfg.rope_theta))
    pos = _positions(q.shape[1], offset, q.device)
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta))


def _inputs(params: nn.Module, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """The embedded ``tokens``, or ``embeds`` in the config's dtype."""
    if "tokens" in batch:
        return embed(params.embed, batch["tokens"], cfg)
    return batch["embeds"].to(cfg.dtype)


def layer_apply(p: Layer, x: torch.Tensor, cfg: ModelConfig, *,
                backend: str = "chunked", pos3=None, sp: bool = False
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Returns (x_out, aux loss).  With ``sp`` x holds this rank's
    positions under the sequence split (``pos3`` too): RoPE from its
    first position, K/V all-gathered along S (with a gradient) and the
    causal attention at that ``q_offset``, as the reference's
    ``chunked_attention`` pins gathered K/V."""
    attn = fsdp_params(p.attn, cfg)
    h = rmsnorm(p.ln1, x)
    q, k, v = qkv_project(attn, h, cfg)
    start = tp.local_start(x.shape[1]) if sp else 0
    q, k = _rope(cfg, q, k, start, pos3)
    if sp:
        k, v = tp.gather_seq(k), tp.gather_seq(v)
    o = attn_mod.attention(q, k, v, causal=True, q_offset=start,
                           backend=backend)
    x = x + out_project(attn, o)
    m, aux = ffn(p, rmsnorm(p.ln2, x), cfg)
    return x + m, aux


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def lm_apply(params: DenseLM, batch: Dict[str, torch.Tensor],
             cfg: ModelConfig, *, backend: str = "chunked",
             remat: bool = True) -> Dict[str, torch.Tensor]:
    """``batch["tokens"]`` [B,S] or ``batch["embeds"]`` [B,S,D] (and
    ``pos3``) -> ``hidden`` [B,S,D], ``aux_loss`` (the layers' sum over
    ``n_layers``; 0 for a dense model) and ``logits`` [B,S,V] float32.
    Differentiable; ``remat`` rematerialises each layer in the backward
    pass (``layers.remat_call``).  Under the sequence split
    (``tp.sequence_parallel``, the reference's ``activation_hint``) each
    rank runs and returns its S/m positions of its rows."""
    sp = tp.sequence_parallel(cfg, next(iter(batch.values())).shape[1])
    if sp:
        batch = {k: tp.chunk(v, 1) for k, v in batch.items()}
    x = _inputs(params, batch, cfg)
    pos3 = batch.get("pos3")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        x, a = remat_call(functools.partial(layer_apply, layer, cfg=cfg,
                                            backend=backend, pos3=pos3,
                                            sp=sp),
                          x, remat=remat)
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
    with a clamped index and a select, so nothing waits for the device.
    A cache in another layout takes ``new`` in its own
    (``tp.to_cache``: a Dh-sharded cache its Dh slice)."""
    new = tp.to_cache(new, cache[:, :1])
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
                  backend: str, pos3=None, sp: bool = False) -> torch.Tensor:
    """One layer of prefill (``offset`` an int: writes the cache at
    [offset, offset + S)) or decode (``offset`` a [B] tensor: writes each
    row at its own position, then attends over the cache).  ``kc``/``vc``
    are this layer's [B, Smax, KV, Dh] views of the cache (or of its
    rank's shard, ``tp.to_cache``), updated in place.  ``pos3`` goes to
    ``_rope``.  With ``sp`` x holds the rank's positions [offset,
    offset + S/m) of a prompt written from 0: K/V are all-gathered along S
    before the write and the attention.  The feed-forward's aux loss is
    dropped, as the reference's is."""
    attn = fsdp_params(p.attn, cfg)
    h = rmsnorm(p.ln1, x)
    q, k, v = qkv_project(attn, h, cfg)
    q, k = _rope(cfg, q, k, offset, pos3)
    q_offset = offset
    if sp:                     # the reference's attention.py:59-60
        k, v, offset = tp.gather_seq(k), tp.gather_seq(v), 0
    s = k.shape[1]
    if isinstance(offset, int):
        if offset < 0 or offset + s > kc.shape[1]:
            raise ValueError(f"prefill of {s} tokens at {offset} does not "
                             f"fit a cache of {kc.shape[1]}")
        kw = kc[:, offset:offset + s]
        vw = vc[:, offset:offset + s]
        kw[...] = tp.to_cache(k, kw).to(kc.dtype)
        vw[...] = tp.to_cache(v, vw).to(vc.dtype)
    else:
        _scatter_kv(kc, k, offset)
        _scatter_kv(vc, v, offset)
    if x.shape[1] == 1 and not sp:
        o = attn_mod.decode_attention(q, kc, vc, cache_len)
    else:
        o = attn_mod.attention(q, k, v, causal=True, q_offset=q_offset,
                               backend=backend)
    x = x + out_project(attn, o)
    return x + ffn(p, rmsnorm(p.ln2, x), cfg)[0]


@torch.no_grad()
def lm_prefill(params: DenseLM, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, cache: Cache, *,
               backend: str = "chunked") -> Tuple[torch.Tensor, Cache]:
    """Full-prompt forward; fills cache[:, :, :S] in place; returns the
    last position's logits [B, 1, V] float32 and the cache with
    ``len = S``.  The batch holds ``tokens`` or ``embeds`` (and
    ``pos3``), as ``lm_apply``'s does.  Sequence parallel on a mesh
    (``tp.sequence_parallel``): each rank runs its S/m positions of the
    batch leaves, and the last position comes from the last rank."""
    s = next(iter(batch.values())).shape[1]
    sp = tp.sequence_parallel(cfg, s)
    if sp:
        batch = {k: tp.chunk(v, 1) for k, v in batch.items()}
    x = _inputs(params, batch, cfg)
    start = tp.local_start(x.shape[1]) if sp else 0
    pos3 = batch.get("pos3")
    for i, layer in enumerate(params.layers):
        x = _cached_layer(layer, cache["k"][i], cache["v"][i], x, cfg,
                          start, None, backend=backend, pos3=pos3, sp=sp)
    x = x[:, -1:]
    if sp:
        x = tp.from_last_rank(x)
    x = rmsnorm(params.final_norm, x)
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": torch.full_like(cache["len"], s)}


@torch.no_grad()
def lm_decode_step(params: DenseLM, tokens: Optional[torch.Tensor],
                   cache: Cache, cfg: ModelConfig,
                   batch_extra: Optional[Dict[str, torch.Tensor]] = None, *,
                   backend: str = "kernel") -> Tuple[torch.Tensor, Cache]:
    """tokens [B,1], or ``None`` with ``batch_extra["embeds"]`` [B,1,D];
    ``batch_extra["pos3"]`` [B,1,3] gives an M-RoPE config its positions.
    Each row's cache slot (and plain RoPE position) is its ``len``.
    Returns logits [B, 1, V] float32 and the cache (written in place) with
    ``len + 1``.  The step attends over the cache by its one-token path
    (``decode_attention``) whatever ``backend`` names, the prefill's
    attention, which a serving loop passes to every family."""
    batch = dict(batch_extra or {})
    if tokens is not None:
        batch["tokens"] = tokens
    x = _inputs(params, batch, cfg)
    pos3 = batch.get("pos3")
    pos = tp.local_rows(cache["len"], x.shape[0])                # [B]
    for i, layer in enumerate(params.layers):
        x = _cached_layer(layer, cache["k"][i], cache["v"][i], x, cfg, pos,
                          pos + 1, backend="naive", pos3=pos3)
    x = rmsnorm(params.final_norm, x)
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": cache["len"] + 1}
