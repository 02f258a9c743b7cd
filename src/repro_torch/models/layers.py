"""Shared neural layers of the LM families: port of
``src/repro/models/layers.py`` (M-RoPE is not ported yet, ROADMAP queue 1
item 11).

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

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The dense, MoE, SSM and hybrid families' fields of the reference's
    config, with its defaults.  The other families' fields (enc-dec,
    M-RoPE, frontends, FSDP) come with the slices that read them."""

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
    dtype: torch.dtype = torch.bfloat16

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


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; pos: [B, S] (or [1, S]) integer positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [Dh/2]
    ang = pos[..., None].float() * freqs                       # [B, S, Dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    """Returns q [B,S,H,Dh], k/v [B,S,KV,Dh] (pre-RoPE, post-qk-norm).  The
    reference's cross-attention input (``kv_x``) is not ported yet (the
    encdec family, ROADMAP queue 1 item 11)."""
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (x @ p.wk).reshape(b, s, cfg.n_kv, cfg.d_head)
    v = (x @ p.wv).reshape(b, s, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    return q, k, v


def out_project(p: Attention, attn: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = attn.shape
    return attn.reshape(b, s, h * dh) @ p.wo


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), op by op as the reference's ``jax.nn.silu`` lowers:
    exp, add, divide and multiply each round to x's dtype.  In bf16 this
    equals the reference bit for bit; ``F.silu`` rounds once and differs
    by an ulp on about 40 % of inputs."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ p.wg) * (x @ p.wi)
    return h @ p.wo


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p.tok)


def unembed(p: Unembed, emb: Embed, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Logits [B, S, V] in float32.  The reference multiplies with float32
    accumulation (``preferred_element_type``); a bf16 product here would
    round the logits to bf16 and could flip a greedy argmax.  So both
    operands go to float32 for this one product: a bf16 x bf16 product is
    exact in float32, and on the card float32 matmuls run in full float32
    unless the caller enables TF32.  At qwen3-4b's width that is a 1.56 GB
    float32 transient of the [2560, 151936] weight per call."""
    w = emb.tok.T if cfg.tie_embeddings else p.w
    return x.float() @ w.float()
