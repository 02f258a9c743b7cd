"""Mixture-of-Experts layer: top-k router and capacity-bucketed dispatch.
Port of ``src/repro/models/moe.py``.

Dispatch scatters the (token, choice) pairs into an ``[E, C, D]`` capacity
buffer (C = ``_capacity``), so the expert FFN is one batched product over
all experts; pairs past an expert's capacity are dropped, and the router
keeps the reference's auxiliary load-balancing loss.  As in the
reference, ``moe_apply`` takes the expert-parallel path (``moe_ep.py``:
explicit all-to-alls over the mesh's ``"model"`` axis) whenever an
ambient mesh and the batch allow it, and the dense path below otherwise;
on a mesh the dense path all-gathers the expert banks first
(``fsdp_params``) and routes the rank's own tokens (its rows, or its
positions of them under the sequence split) at a capacity from their
count, where the reference's GSPMD takes one capacity from the global
batch's (the two agree wherever neither drops a pair), with the aux loss
over the global batch (``aux_loss(world=True)``); except under tensor
parallelism (``cfg.fsdp`` False,
the reference's "TP decode"): there every ``"model"`` rank holds the same
tokens, routes all of them as one device does (the same capacity and the
same drops), fills and multiplies only its own E/m experts' buffers, and
one float32 all-reduce sums the ranks' contributions.  The banks are
never gathered.

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

from ..sharding import tp
from ..sharding.mesh import current_mesh
from ..sharding.rules import fsdp_params
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


def top_k(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """The router over xt [T, D]: (probs [T, E], gate [T, k] normalised,
    expert [T, k]), all float32 but ``expert``."""
    probs = torch.softmax(xt.float() @ router, dim=-1)           # [T, E]
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :cfg.top_k], expert[:, :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate, expert


def aux_loss(probs: torch.Tensor, expert: torch.Tensor,
             n_experts: int, *, world: bool = False) -> torch.Tensor:
    """Switch-style load balance: E * sum_e f_e * P_e.  With ``world``
    it is the whole global batch's, as the reference's dense path takes
    it under GSPMD: every rank's per-expert probability sums and counts
    are summed over the default group before the product (replicas
    cancel in the ratios), and the gradient flows through this rank's
    mean probabilities against the global f (``tp.valued``: the world
    size times the rank's share, as ``train/loss.py`` takes it)."""
    flat_e = expert.reshape(-1)
    ones = torch.ones(flat_e.shape[0], dtype=torch.float32,
                      device=flat_e.device)
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=flat_e.device).index_add_(0, flat_e, ones)
    if not world:
        ce = counts / flat_e.shape[0]
        return n_experts * torch.sum(probs.mean(dim=0) * ce)
    import torch.distributed as dist
    w = dist.get_world_size()
    g = tp.world_sum(torch.cat([probs.sum(dim=0), counts]))
    ce = g[n_experts:] / (flat_e.shape[0] * w)
    value = n_experts * torch.sum(g[:n_experts] / (probs.shape[0] * w) * ce)
    return tp.valued(n_experts * torch.sum(probs.mean(dim=0) * ce), value)


def rank_by(dest: torch.Tensor, n_bins: int, cap: int):
    """Each element's rank within its bin, in index order (a stable
    argsort): (slot = dest * cap + rank, or dest * cap past the capacity;
    keep = rank < cap)."""
    n = dest.shape[0]
    counts = torch.zeros(n_bins, dtype=torch.int64,
                         device=dest.device).index_add_(
        0, dest, torch.ones_like(dest))
    offsets = torch.cumsum(counts, 0) - counts                   # exclusive
    order = torch.argsort(dest, stable=True)
    rank_sorted = torch.arange(n, device=dest.device) - offsets[dest[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    return dest * cap + torch.where(keep, rank, 0), keep


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig, cap: int, *,
          world: bool = False):
    """The router over xt [T, D]: (gate [T, k] float32, expert [T, k],
    keep [T*k] bool, slot [T*k], aux loss float32 scalar, the global
    batch's with ``world``); each pair's slot is its rank within its
    expert in (token, choice) order."""
    probs, gate, expert = top_k(tp.local(p.router), xt, cfg)
    slot, keep = rank_by(expert.reshape(-1), cfg.n_experts, cap)
    return gate, expert, keep, slot, aux_loss(probs, expert, cfg.n_experts,
                                              world=world)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux loss float32)."""
    from .moe_ep import ep_applicable, moe_apply_ep
    if ep_applicable(cfg):
        return moe_apply_ep(p, x, cfg)
    p = fsdp_params(p, cfg)
    wi, wg, wo = (tp.local(w) for w in (p.wi, p.wg, p.wo))
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    cap = _capacity(t, cfg)
    xt = x.reshape(t, d)
    # FSDP on a mesh: each rank routes its own tokens (its rows, or its
    # positions of them under the sequence split) and the aux loss is the
    # global batch's
    gate, expert, keep, slot, aux = route(
        p, xt, cfg, cap, world=cfg.fsdp and current_mesh() is not None)

    # this rank's experts [e0, e0 + e_loc): all of them but under TP
    e_loc = wi.shape[0]
    e0 = 0 if tp.split_dim(p.wi) is None else tp.model_axis()[1] * e_loc
    flat_e = expert.reshape(-1)
    mine = keep & (flat_e >= e0) & (flat_e < e0 + e_loc)
    lslot = (slot - e0 * cap).clamp(0, e_loc * cap - 1)

    # dispatch: each kept pair into its slot; a dropped pair adds zeros
    # into the last slot, as the reference's scatter does
    tok_idx = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(-1)
    rows = torch.where(mine[:, None], xt[tok_idx], 0)
    buf = torch.zeros((e_loc * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, torch.where(mine, lslot, e_loc * cap - 1), rows)
    buf = buf.reshape(e_loc, cap, d)

    hg = _expert_product(buf, wg)
    hi = _expert_product(buf, wi)
    h = (silu(hg) * hi).to(x.dtype)
    out_buf = _expert_product(h, wo)                             # [E, C, D]

    # combine: each kept pair's expert output, weighted by its gate
    w = torch.where(mine, gate.reshape(-1), 0.0)[:, None]
    out = combine(out_buf.reshape(e_loc * cap, d)[lslot] * w, k)
    if e_loc != cfg.n_experts:
        out = tp.all_reduce(out)
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
