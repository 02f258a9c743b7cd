"""Whisper-style encoder-decoder backbone (audio family): port of
``src/repro/models/encdec.py``.

The conv/log-mel frontend is a stub, as in the reference: the caller
supplies precomputed frame embeddings ``enc_embeds`` [B, enc_seq, D].
Encoder: bidirectional self-attention with RoPE at positions 0..Se-1, then
``enc_norm``; decoder: causal self-attention, cross-attention over the
encoder output (no RoPE on its K/V), SwiGLU MLP.  The reference stacks
each side's layers into [L, ...] pytrees for ``lax.scan``; the port keeps
one module per layer in ``enc_layers`` (``n_enc_layers or n_layers`` of
them) and ``dec_layers`` (``n_layers``).

Decode keeps the reference's cache leaves: ``k``/``v`` [L, B, max_len, KV,
Dh] for the decoder's self-attention, ``enc_k``/``enc_v`` [L, B, enc_seq,
KV, Dh] for the (static) cross K/V of the encoder output, and ``len`` [B]
int32.  Prefill and decode write them in place and return the cache, as
``transformer.lm_prefill`` does.  Every attention outside the decode step
goes through ``attention.attention(..., backend=)``: ``"kernel"`` is the
flash kernel for CUDA tensors and its plain version on the CPU.

On a mesh the cache may hold the rank's shard (``cache_specs_tree``: Dh
over ``"model"`` in all four K/V leaves): the prefill, FSDP with no
sequence split (the reference's constrains no activation), writes that
layout, and a decode step with ``cfg.fsdp`` False runs tensor parallel,
both its attentions over the Dh-sharded caches
(``attention.decode_attention``).  The train forward splits each stack's
sequence over ``"model"`` where the global batch leaves it idle
(``encdec_apply``); the encoder's 1500 frames do not divide a 16-way
axis, so there it runs whole on every rank, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import resolve
from ..sharding import tp
from ..sharding.rules import fsdp_params
from . import attention as attn_mod
from .layers import (MLP, Attention, Embed, ModelConfig, RMSNorm, Unembed,
                     embed, fill_normal, mlp, out_project, qkv_project,
                     remat_call, rmsnorm, unembed)
from .transformer import _rope, _scatter_kv, fill_attention

Cache = Dict[str, torch.Tensor]


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MLP(cfg, device)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.self_attn = Attention(cfg, device)
        self.ln_x = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.cross_attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MLP(cfg, device)


def n_enc_layers(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder, named as the reference's param
    tree (``enc_layers.{l}`` holds the reference's stacked leaf at l)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device)
                                        for _ in range(n_enc_layers(cfg)))
        self.enc_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.unembed = Unembed(cfg, device)


@torch.no_grad()
def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> EncDecLM:
    """Random weights with the reference's distributions (projections
    N(0, 1/d_in), embedding and unembedding N(0, 0.02^2), norm scales 1),
    drawn on the generator's device.  The numbers differ from
    ``jax.random``'s; the parity tests carry the reference's weights
    across with ``params_from_jax``."""
    model = EncDecLM(cfg, gen.device)
    for norm in model.modules():
        if isinstance(norm, RMSNorm):
            norm.scale.fill_(1)
    for layer in (*model.enc_layers, *model.dec_layers):
        for a in layer.children():
            if isinstance(a, Attention):
                fill_attention(a, gen, cfg)
        for w in (layer.mlp.wi, layer.mlp.wg, layer.mlp.wo):
            fill_normal(w, gen)
    fill_normal(model.embed.tok, gen, 0.02)
    if not cfg.tie_embeddings:
        fill_normal(model.unembed.w, gen, 0.02)
    return model


def _enc_layer(lp: EncLayer, x: torch.Tensor, cfg: ModelConfig, *,
               backend: str, sp: bool = False) -> torch.Tensor:
    """One encoder layer; with ``sp`` x holds this rank's frames (RoPE
    from its first, K/V gathered along S)."""
    attn = fsdp_params(lp.attn, cfg)
    h = rmsnorm(lp.ln1, x)
    q, k, v = qkv_project(attn, h, cfg)
    q, k = _rope(cfg, q, k, tp.local_start(x.shape[1]) if sp else 0)
    if sp:
        k, v = tp.gather_seq(k), tp.gather_seq(v)
    o = attn_mod.attention(q, k, v, causal=False, backend=backend)
    x = x + out_project(attn, o)
    return x + mlp(fsdp_params(lp.mlp, cfg), rmsnorm(lp.ln2, x))


def encode(params: EncDecLM, enc_embeds: torch.Tensor, cfg: ModelConfig,
           *, backend: str = "chunked", remat: bool = True,
           sp: bool = False) -> torch.Tensor:
    """enc_embeds [B, Se, D] -> the encoder's output [B, Se, D] in the
    config's dtype; ``remat`` as ``encdec_apply``'s.  With ``sp`` the
    frames are this rank's Se/m under the sequence split, and so is the
    output."""
    x = enc_embeds.to(cfg.dtype)
    for lp in params.enc_layers:
        x = remat_call(functools.partial(_enc_layer, lp, cfg=cfg,
                                         backend=backend, sp=sp), x,
                       remat=remat)
    return rmsnorm(params.enc_norm, x)


def _dec_layer(lp: DecLayer, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, *, backend: str,
               cache: Optional[Tuple[torch.Tensor, ...]] = None,
               sp: bool = False, enc_sp: bool = False) -> torch.Tensor:
    """One decoder layer over a prompt from position 0: causal
    self-attention, cross-attention over ``enc_out``, MLP.  With
    ``cache`` (this layer's k, v, enc_k and enc_v views) it also writes
    the self-attention's k/v at [0, S) and the cross K/V of ``enc_out``,
    in place.  Under the sequence split (training): with ``sp`` x holds
    this rank's positions (RoPE from its first, K/V gathered along S,
    the causal attention at that ``q_offset``); with ``enc_sp``
    ``enc_out`` holds this rank's frames and the cross K/V are gathered
    along them."""
    self_attn = fsdp_params(lp.self_attn, cfg)
    cross_attn = fsdp_params(lp.cross_attn, cfg)
    h = rmsnorm(lp.ln1, x)
    q, k, v = qkv_project(self_attn, h, cfg)
    start = tp.local_start(x.shape[1]) if sp else 0
    q, k = _rope(cfg, q, k, start)
    if sp:
        k, v = tp.gather_seq(k), tp.gather_seq(v)
    o = attn_mod.attention(q, k, v, causal=True, q_offset=start,
                           backend=backend)
    x = x + out_project(self_attn, o)
    qx, ek, ev = qkv_project(cross_attn, rmsnorm(lp.ln_x, x), cfg,
                             kv_x=enc_out)
    if enc_sp:
        ek, ev = tp.gather_seq(ek), tp.gather_seq(ev)
    if cache is not None:
        kc, vc, ekc, evc = cache
        s = x.shape[1]
        kc[:, :s] = tp.to_cache(k, kc[:, :s]).to(kc.dtype)
        vc[:, :s] = tp.to_cache(v, vc[:, :s]).to(vc.dtype)
        ekc.copy_(tp.to_cache(ek, ekc))
        evc.copy_(tp.to_cache(ev, evc))
    o = attn_mod.attention(qx, ek, ev, causal=False, backend=backend)
    x = x + out_project(cross_attn, o)
    return x + mlp(fsdp_params(lp.mlp, cfg), rmsnorm(lp.ln2, x))


def encdec_apply(params: EncDecLM, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, backend: str = "chunked",
                 remat: bool = True, logits: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """batch: ``enc_embeds`` [B,Se,D] and ``tokens`` [B,Sd] -> ``hidden``
    [B,Sd,D], ``aux_loss`` (0) and, unless ``logits=False``, ``logits``
    [B,Sd,V] float32.  Differentiable; ``remat`` rematerialises each
    encoder and each decoder layer in the backward pass
    (``layers.remat_call``).  The reference's ``activation_hint`` at each
    layer boundary splits each stack by its own length
    (``tp.sequence_parallel``): the decoder's Sd, the encoder's Se where
    that divides "model" too (whisper's 1500 frames do not divide 16, so
    there the encoder runs whole on every rank); each rank then returns
    its Sd/m positions."""
    enc, tokens = batch["enc_embeds"], batch["tokens"]
    enc_sp = tp.sequence_parallel(cfg, enc.shape[1])
    sp = tp.sequence_parallel(cfg, tokens.shape[1])
    enc_out = encode(params, tp.chunk(enc, 1) if enc_sp else enc, cfg,
                     backend=backend, remat=remat, sp=enc_sp)
    x = embed(params.embed, tp.chunk(tokens, 1) if sp else tokens, cfg)
    for lp in params.dec_layers:
        x = remat_call(functools.partial(_dec_layer, lp, cfg=cfg,
                                         backend=backend, sp=sp,
                                         enc_sp=enc_sp),
                       x, enc_out, remat=remat)
    x = rmsnorm(params.final_norm, x)
    out = {"hidden": x, "aux_loss": torch.zeros((), dtype=torch.float32,
                                                device=x.device)}
    if logits:
        out["logits"] = unembed(params.unembed, params.embed, x, cfg)
    return out


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def encdec_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                      device=None) -> Cache:
    dev = resolve(device)
    kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv, cfg.d_head)
    enc_kv = (cfg.n_layers, batch_size, cfg.enc_seq, cfg.n_kv, cfg.d_head)
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "enc_k": torch.zeros(enc_kv, dtype=cfg.dtype, device=dev),
        "enc_v": torch.zeros(enc_kv, dtype=cfg.dtype, device=dev),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def encdec_prefill(params: EncDecLM, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, cache: Cache, *,
                   backend: str = "chunked") -> Tuple[torch.Tensor, Cache]:
    """Encode the audio, store each layer's cross K/V of it, run the
    decoder prompt from position 0 (writing k/v at [0, S)), all in place;
    returns the last position's logits [B, 1, V] float32 and the cache
    with ``len = S``."""
    s, se = batch["tokens"].shape[1], batch["enc_embeds"].shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prefill of {s} tokens does not fit a cache of "
                         f"{cache['k'].shape[2]}")
    if se != cache["enc_k"].shape[2]:
        raise ValueError(f"{se} encoder frames, the cache holds "
                         f"{cache['enc_k'].shape[2]}")
    enc_out = encode(params, batch["enc_embeds"], cfg, backend=backend)
    x = embed(params.embed, batch["tokens"], cfg)
    for i, lp in enumerate(params.dec_layers):
        x = _dec_layer(lp, x, enc_out, cfg, backend=backend,
                       cache=tuple(cache[n][i] for n in
                                   ("k", "v", "enc_k", "enc_v")))
    x = rmsnorm(params.final_norm, x[:, -1:])
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {**cache, "len": torch.full_like(cache["len"], s)}


@torch.no_grad()
def encdec_decode_step(params: EncDecLM, tokens: torch.Tensor, cache: Cache,
                       cfg: ModelConfig, *, backend: str = "kernel"
                       ) -> Tuple[torch.Tensor, Cache]:
    """tokens [B,1]; each row's RoPE position and cache slot is its
    ``len``.  Self-attention over the cache at ``len + 1`` and
    cross-attention over every ``enc_seq`` position of ``enc_k``/``enc_v``,
    both by the one-token path (``decode_attention``), whatever
    ``backend`` names.  Returns logits [B, 1, V] float32 and the cache
    (written in place) with ``len + 1``."""
    x = embed(params.embed, tokens, cfg)
    b = tokens.shape[0]
    pos = tp.local_rows(cache["len"], b)                         # [B]
    enc_len = torch.full((b,), cache["enc_k"].shape[2], dtype=torch.int32,
                         device=x.device)
    for i, lp in enumerate(params.dec_layers):
        kc, vc = cache["k"][i], cache["v"][i]
        self_attn = fsdp_params(lp.self_attn, cfg)
        cross_attn = fsdp_params(lp.cross_attn, cfg)
        h = rmsnorm(lp.ln1, x)
        q, k, v = qkv_project(self_attn, h, cfg)
        q, k = _rope(cfg, q, k, pos)
        _scatter_kv(kc, k, pos)
        _scatter_kv(vc, v, pos)
        o = attn_mod.decode_attention(q, kc, vc, pos + 1)
        x = x + out_project(self_attn, o)
        qx, _, _ = qkv_project(cross_attn, rmsnorm(lp.ln_x, x), cfg)
        o = attn_mod.decode_attention(qx, cache["enc_k"][i],
                                      cache["enc_v"][i], enc_len)
        x = x + out_project(cross_attn, o)
        x = x + mlp(fsdp_params(lp.mlp, cfg), rmsnorm(lp.ln2, x))
    x = rmsnorm(params.final_norm, x)
    logits = unembed(params.unembed, params.embed, x, cfg)
    return logits, {**cache, "len": cache["len"] + 1}
