"""Mixture-of-Experts layer: top-k router and capacity-bucketed dispatch.
Port of ``src/repro/models/moe.py``.

Dispatch scatters the (token, choice) pairs into an ``[E, C, D]`` capacity
buffer (C = ``_capacity``), so the expert FFN is one batched product over
all experts; pairs past an expert's capacity are dropped, and the router
keeps the reference's auxiliary load-balancing loss.  The reference's
expert-parallel branch (``moe_ep``, taken only under a JAX device mesh) is
not ported (ROADMAP queue 1 item 12): the port always runs the dense path
below, the reference's path on one device.

Exactness of the routing: the router runs in float32 (on the card with
TF32 off, PyTorch's default), the top k comes from a stable descending
sort, so tied probabilities go to the lower expert first as in
``jax.lax.top_k``, and each pair's slot is its rank among the pairs of
its expert in (token, choice) order, from a stable argsort, as in the
reference.  Pad tokens take capacity as they do there.  Nothing here
waits for the device: the capacity is static in the shapes.

The expert products take the buffer in the model's dtype and accumulate
in float32 (the reference's ``preferred_element_type``): on the card by
``torch.bmm(..., out_dtype=torch.float32)``, which keeps the bf16 weights
as they are; on the CPU, which has no kernel for that, both operands are
upcast (a bf16 product is exact in float32).  The combine adds each
token's k weighted expert outputs in choice order, ((0 + c_0) + c_1) +
..., the order of XLA's scatter-add on the CPU, with no atomics.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .layers import ModelConfig, _param, silu


class MoE(nn.Module):
    """router [D, E] float32; wi, wg [E, D, F] and wo [E, F, D] in the
    model's dtype."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
        self.router = _param((d, e), torch.float32, device)
        self.wi = _param((e, d, f), cfg.dtype, device)
        self.wg = _param((e, d, f), cfg.dtype, device)
        self.wo = _param((e, f, d), cfg.dtype, device)


@torch.no_grad()
def fill_moe(p: MoE, gen: torch.Generator) -> MoE:
    """Fill ``p`` in place with the reference's distributions: the router
    N(0, 1/D) in float32, each expert's [d_in, d_out] weight N(0, 1/d_in),
    drawn one expert at a time (float32 transients of one expert)."""
    d = p.router.shape[0]
    z = torch.randn(p.router.shape, generator=gen, device=p.router.device)
    p.router.copy_(z / math.sqrt(d))
    for w in (p.wi, p.wg, p.wo):
        scale = 1.0 / math.sqrt(w.shape[1])
        for e in range(w.shape[0]):
            z = torch.randn(w.shape[1:], generator=gen, device=w.device)
            w[e].copy_((z * scale).to(w.dtype))
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _expert_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, d_in] x [E, d_in, d_out] -> [E, C, d_out] float32, with
    float32 accumulation."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(a, w)
    if a.device.type == "cpu":
        return torch.bmm(a.float(), w.float())
    return torch.bmm(a, w, out_dtype=torch.float32)


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig, cap: int):
    """The router over xt [T, D]: (gate [T, k] float32, expert [T, k],
    keep [T*k] bool, slot [T*k], aux loss float32 scalar)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    probs = torch.softmax(xt.float() @ p.router, dim=-1)         # [T, E]
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :k], expert[:, :k]
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)

    # Switch-style load balance: E * sum_e f_e * P_e
    flat_e = expert.reshape(-1)                                  # [T*k]
    ones = torch.ones(t * k, dtype=torch.float32, device=dev)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, ones) / (t * k)
    aux = e * torch.sum(probs.mean(dim=0) * ce)

    # each pair's rank within its expert, in (token, choice) order
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts                   # exclusive
    order = torch.argsort(flat_e, stable=True)
    rank_sorted = torch.arange(t * k, device=dev) - offsets[flat_e[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    slot = flat_e * cap + torch.where(keep, rank, 0)
    return gate, expert, keep, slot, aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux loss float32)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    xt = x.reshape(t, d)
    gate, _, keep, slot, aux = route(p, xt, cfg, cap)

    # dispatch: each kept pair into its slot; a dropped pair adds zeros
    # into the last slot, as the reference's scatter does
    tok_idx = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(-1)
    rows = torch.where(keep[:, None], xt[tok_idx], 0)
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, torch.where(keep, slot, e * cap - 1), rows)
    buf = buf.reshape(e, cap, d)

    hg = _expert_product(buf, p.wg)
    hi = _expert_product(buf, p.wi)
    h = (silu(hg) * hi).to(x.dtype)
    out_buf = _expert_product(h, p.wo)                           # [E, C, D]

    # combine: each kept pair's expert output, weighted by its gate
    w = torch.where(keep, gate.reshape(-1), 0.0)[:, None]
    out = combine(out_buf.reshape(e * cap, d)[slot] * w, k)
    return out.reshape(b, s, d).to(x.dtype), aux


def combine(contrib: torch.Tensor, k: int) -> torch.Tensor:
    """contrib [T*k, D] float32, token-major -> [T, D]: each token's k
    rows added in choice order from zero, ((0 + c_0) + c_1) + ..., as
    XLA's scatter-add of the reference runs on the CPU."""
    contrib = contrib.reshape(-1, k, contrib.shape[-1])
    out = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        out = out + contrib[:, j]
    return out
