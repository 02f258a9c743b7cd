"""Shared neural layers of the LM families: port of
``src/repro/models/layers.py``.

Parameters live in ``nn.Module``s whose attribute names follow the JAX
param tree's keys, so ``models/weights.py::params_from_jax`` maps one onto
the other by name; every weight keeps the reference's [d_in, d_out] layout,
so ``x @ w`` means the same in both packages.  The apply functions are plain
tensor functions of (module, inputs), as the reference's are of
(params, inputs).  Conventions: activations [B, S, D]; attention heads
[B, S, H, Dh].  Normalisation and RoPE run in float32 and cast back; the
logits come out in float32 (see ``unembed``).
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..sharding import tp
from ..sharding.rules import fsdp_params, replicate_hint


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config: its fields and defaults."""

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv: int = 2
    d_head: int = 32
    d_ff: int = 256
    vocab: int = 1024
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope: bool = False            # Qwen2-VL multimodal RoPE (3 position axes)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1             # MoE MLP every k-th layer (1 = all layers)
    capacity_factor: float = 1.25
    # SSM (Mamba1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (Jamba): attention layer every `attn_every` layers
    attn_every: int = 0            # 0 = not hybrid
    # enc-dec (Whisper): encoder config
    n_enc_layers: int = 0
    enc_seq: int = 1500            # whisper: 30 s audio -> 1500 frames
    # frontend stubs
    frontend: str = "token"        # token | embed (precomputed frame/patch)
    dtype: torch.dtype = torch.bfloat16
    # mesh layout: True = FSDP (weights gathered at use), False = Megatron
    # tensor parallelism (weights left sharded; ``sharding/tp.py``)
    fsdp: bool = True

    @property
    def d_inner(self) -> int:      # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def is_moe_arch(self) -> bool:
        return self.n_experts > 0

    def moe_layer(self, layer_idx: int) -> bool:
        return self.is_moe_arch and (layer_idx % self.moe_every
                                     == self.moe_every - 1)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# modules (parameters only; filled by lm_init or params_from_jax)
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)


class Attention(nn.Module):
    """GQA projections: wq [D, H*Dh], wk/wv [D, KV*Dh], wo [H*Dh, D], and
    the per-head q/k RMSNorms when ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, kv, dh, dt = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                            cfg.dtype)
        self.wq = _param((d, h * dh), dt, device)
        self.wk = _param((d, kv * dh), dt, device)
        self.wv = _param((d, kv * dh), dt, device)
        self.wo = _param((h * dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, dt, device)
            self.k_norm = RMSNorm(dh, dt, device)


class MLP(nn.Module):
    """SwiGLU: wi, wg [D, F], wo [F, D]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = _param((d, f), cfg.dtype, device)
        self.wg = _param((d, f), cfg.dtype, device)
        self.wo = _param((f, d), cfg.dtype, device)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.tok = _param((cfg.vocab, cfg.d_model), cfg.dtype, device)


class Unembed(nn.Module):
    """Holds ``w`` [D, V] unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if not cfg.tie_embeddings:
            self.w = _param((cfg.d_model, cfg.vocab), cfg.dtype, device)


# ---------------------------------------------------------------------------
# initialisers (the reference's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


@torch.no_grad()
def fill_normal(p: torch.Tensor, gen: torch.Generator,
                scale: Optional[float] = None) -> None:
    """``p <- N(0, 1) * scale`` drawn in float32 and cast to p's dtype;
    the default scale is 1/sqrt(d_in) of a [d_in, d_out] weight."""
    scale = scale if scale is not None else 1.0 / math.sqrt(p.shape[0])
    z = torch.randn(p.shape, generator=gen, device=p.device,
                    dtype=torch.float32)
    p.copy_((z * scale).to(p.dtype))


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------


def remat_call(fn, *args, remat: bool):
    """``fn(*args)``, a layer of a full-sequence forward.  With ``remat``
    and grad mode on it runs under ``torch.utils.checkpoint``, which keeps
    only the layer's inputs and runs the layer again in the backward pass
    (the reference's ``jax.checkpoint`` of its scanned layer); otherwise,
    or with grad mode off, it is a plain call.  The layers draw no random
    numbers, so no RNG state is stashed.  The run again is in the context
    of the call (``contextvars``): on the card the backward pass runs in
    autograd's device thread, where the ambient mesh of ``use_mesh``
    would otherwise be unset."""
    if remat and torch.is_grad_enabled():
        ctx = contextvars.copy_context()
        return checkpoint(lambda *a: ctx.run(fn, *a), *args,
                          use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * replicate_hint(p.scale).float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh] rotated by the float32 angles ang [B, S, Dh/2]
    (half-split pairs), cast back to x's dtype."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; pos: [B, S] (or [1, S]) integer positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [Dh/2]
    return _rotate(x, pos[..., None].float() * freqs)          # [B, S, Dh/2]


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections=(1, 1, 2)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: pos3 [B, S, 3] (t, h, w); the Dh/2 frequency
    channels are split between the three axes in ``sections`` proportion
    (the reference's (1, 1, 2), in channel order t, h, w), each channel
    rotated by its axis's position."""
    half = x.shape[-1] // 2
    tot = sum(sections)
    n_t = half * sections[0] // tot
    n_h = half * sections[1] // tot
    axis_of = torch.full((half,), 2, dtype=torch.int64, device=x.device)
    axis_of[:n_t] = 0
    axis_of[n_t:n_t + n_h] = 1
    pos = pos3.float()[..., axis_of]                           # [B, S, half]
    return _rotate(x, pos * rope_freqs(x.shape[-1], theta, x.device))


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                kv_x: Optional[torch.Tensor] = None):
    """Returns q [B,S,H,Dh] from x and k/v [B,Skv,KV,Dh] from ``kv_x``
    (x itself by default; the encoder's output for cross-attention),
    pre-RoPE, post-qk-norm.  Column-parallel weights (tensor parallelism)
    give each rank its run of columns, which are all-gathered into whole
    heads before the norm: a rank's run may end inside a head."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    skv = kv_x.shape[1]
    q, k, v = tp.columns((x, p.wq), (kv_x, p.wk), (kv_x, p.wv))
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, skv, cfg.n_kv, cfg.d_head)
    v = v.reshape(b, skv, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    return q, k, v


def out_project(p: Attention, attn: torch.Tensor) -> torch.Tensor:
    """attn [B,S,H,Dh] whole heads @ wo; a row-parallel wo takes the
    rank's run of the H*Dh inputs and sums over "model"."""
    b, s, h, dh = attn.shape
    return tp.row(tp.in_chunk(attn.reshape(b, s, h * dh), p.wo), p.wo)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), op by op as the reference's ``jax.nn.silu`` lowers:
    exp, add, divide and multiply each round to x's dtype.  In bf16 this
    equals the reference bit for bit; ``F.silu`` rounds once and differs
    by an ulp on about 40 % of inputs."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU.  Under tensor parallelism wi/wg give the rank its run of F
    and wo takes the same run: no gather, one all-reduce."""
    h = silu(tp.column(x, p.wg)) * tp.column(x, p.wi)
    return tp.row(h, p.wo)


def embed(p: Embed, tokens: torch.Tensor,
          cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """On a mesh the table is gathered at use, or, with ``cfg.fsdp``
    False, looked up vocab-parallel (``tp.embedding``)."""
    return tp.embedding(tokens, fsdp_params(p, cfg).tok)


def unembed(p: Unembed, emb: Embed, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Logits [B, S, V] in float32.  The reference multiplies with float32
    accumulation (``preferred_element_type``); a bf16 product here would
    round the logits to bf16 and could flip a greedy argmax.  So both
    operands go to float32 for this one product: a bf16 x bf16 product is
    exact in float32, and on the card float32 matmuls run in full float32
    unless the caller enables TF32.  At qwen3-4b's width that is a 1.56 GB
    float32 transient of the [2560, 151936] weight per call.  On a mesh
    the weight is all-gathered at use (``replicate_hint``), as the
    embedding is; with ``cfg.fsdp`` False each rank multiplies its vocab
    columns and the logits are all-gathered (``tp.logits``)."""
    if cfg.tie_embeddings:
        tok = fsdp_params(emb, cfg).tok
        return tp.logits(x, tp.local(tok).T, tp.split_dim(tok) is not None)
    w = fsdp_params(p, cfg).w
    return tp.logits(x, tp.local(w), tp.split_dim(w) is not None)
