"""Attention backends: naive, chunked (flash-style online softmax), kernel,
and the one-token decode.  Port of ``src/repro/models/attention.py``.

All take q [B,S,H,Dh], k/v [B,Skv,KV,Dh] with GQA (H = G*KV).  ``"kernel"``
is the counterpart of the reference's ``"pallas"``: it goes through
``kernels/flash_attention/ops.py``, which launches the hand-written CUDA
kernel for CUDA tensors and runs the plain version for CPU tensors.  The
reference's sharding hints (``shard_hint`` on k/v and on the decode query)
only constrain GSPMD's layout; the port's activations are rank-local on a
mesh, so where that layout splits the work the port splits it by hand: a
decode step over a cache whose Dh lies over the mesh's ``"model"`` axis
(``cache_specs_tree``) takes the query's matching Dh slice and all-reduces
the partial logits, as the reference's ``decode_attention`` does with its
Dh-sharded query; a sequence-parallel prefill gathers K/V along S before
it calls ``attention`` (``models/transformer.py``).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..sharding import tp
from ..kernels.flash_attention.ref import (NEG_INF, naive_attention,
                                           softmax_scale)

BACKENDS = ("naive", "chunked", "kernel")

__all__ = ["BACKENDS", "NEG_INF", "attention", "chunked_attention",
           "decode_attention", "naive_attention"]


def chunked_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      block_k: int = 512) -> torch.Tensor:
    """Flash-style attention: a loop over KV blocks with running (m, l, acc);
    never materialises the [Sq, Skv] scores and keeps kv heads grouped."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    dev = q.device
    qg = q.reshape(b, sq, kv, g, dh)
    nblk = -(-skv // block_k)
    pad = nblk * block_k - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = softmax_scale(dh)
    qpos = torch.arange(sq, device=dev)[:, None] + q_offset       # [Sq, 1]

    m = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, sq, dh), dtype=torch.float32, device=dev)
    for i in range(nblk):
        kblk = k[:, i * block_k:(i + 1) * block_k]                # [B,bk,KV,Dh]
        vblk = v[:, i * block_k:(i + 1) * block_k]
        logits = torch.einsum("bqngd,bknd->bngqk", qg.float(),
                              kblk.float()) * scale
        kpos = i * block_k + torch.arange(block_k, device=dev)[None, :]
        mask = kpos <= (skv - 1)                                  # pad mask
        if causal:
            mask = mask & (qpos >= kpos)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])                  # [B,KV,G,Sq,bk]
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bngqk,bknd->bngqd", p.to(vblk.dtype), vblk)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]              # [B,KV,G,Sq,Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Single-step decode: q [B,1,H,Dh] against the cache [B,Smax,KV,Dh].

    ``cache_len`` [B] or a scalar = number of valid cache entries (the new
    token's k/v must already be written at position cache_len-1).  Grouped
    heads: K/V are never expanded to H heads.

    A cache holding this rank's Dh slice of every head (Dh over the
    mesh's ``"model"`` axis; q has whole heads) takes q's matching slice:
    the partial logits are all-reduced in float32, every rank runs the
    mask and the softmax, and the rank's slice of the output is
    all-gathered back into whole heads."""
    b, _, h, dh = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    dev = q.device
    split = k_cache.shape[-1] != dh
    qg = (tp.chunk(q, -1) if split else q).reshape(b, kv, g, -1)
    logits = torch.einsum("bngd,bsnd->bngs", qg.float(), k_cache.float())
    if split:
        logits = tp.all_reduce(logits)
    logits = logits * softmax_scale(dh)
    kpos = torch.arange(k_cache.shape[1], device=dev)
    valid = kpos[None, :] < torch.as_tensor(cache_len,
                                            device=dev).reshape(-1, 1)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", w.to(v_cache.dtype), v_cache)
    out = out.reshape(b, 1, h, -1)
    return tp.all_gather(out, -1) if split else out


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              backend: str = "chunked", block_k: int = 512) -> torch.Tensor:
    if backend == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    if backend == "chunked":
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 block_k=block_k)
    if backend == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset)
    raise ValueError(f"unknown attention backend {backend!r} "
                     f"(one of {BACKENDS})")
