"""Expert-parallel MoE over explicit all-to-alls: port of
``src/repro/models/moe_ep.py``.

The reference runs ``inner`` under ``shard_map``; the port runs the same
program on the rank's own tokens and its ``E / m`` experts, ``m`` the
size of the ambient mesh's ``"model"`` axis:

  route the local tokens -> per-destination-rank send buffers
  -> all-to-all over "model" -> the local experts' FFN
  -> all-to-all back -> combine with the gates.

Wire per chip per layer = 2 x cap_send·m·D·bytes (there and back) in
the forward; the backward of an all-to-all is an all-to-all, so it costs
the same.  Both all-to-alls are
``torch.distributed._functional_collectives.all_to_all_single_autograd``,
so a gradient reaches ``wi``/``wg``/``wo``/``router`` and the collective
recorder (``roofline/collectives.py``) sees them; the local expert ids
travel by the plain ``all_to_all_single``.

Every buffer is sized by static functions of the local token count
(``cap_send``, ``cap2``, as the reference's): nothing reads a count from
the device.  The expert products are ``moe._expert_product`` (float32
accumulation); the combine adds each token's k contributions in choice
order, as the dense path's does.

One divergence from the reference, a fault of its own: its second stage
buckets the received padding rows (the empty send slots, local expert id
0) with local expert 0's tokens, so where more padding than ``cap2``
arrives before them (a large capacity factor, several source ranks) real
tokens are dropped.  The port sends each kept pair's local expert id + 1
(0 marks padding), and padding takes no capacity.  Where the reference
drops none the two agree (tests/test_torch_moe_ep.py).

Requirements (``ep_applicable``): FSDP weights (``cfg.fsdp``: under
tensor parallelism every ``"model"`` rank holds the same tokens, which EP
would process m times; ``moe_apply``'s dense path splits the experts
instead), an ambient mesh with a ``"model"`` axis of ``m > 1``,
``E % m == 0``, and a global batch that divides the whole mesh: the one
``use_mesh(global_batch=)`` names (required on such a mesh), as the
reference's rule reads it from its global ``x`` (so a batch that leaves
"model" idle, replicated over it or with the sequence split over it,
takes the dense path, as the reference's GSPMD does).
``moe_apply`` falls back to the dense path otherwise.  Called directly,
``moe_apply_ep`` also runs on a ``"model"`` axis of one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..sharding.mesh import (axis_sizes, current_global_batch,
                             current_mesh, mesh_chips)
from .layers import ModelConfig, silu
from .moe import MoE, _expert_product, aux_loss, combine, rank_by, top_k


def ep_applicable(cfg: ModelConfig) -> bool:
    mesh = current_mesh()
    if mesh is None or "model" not in axis_sizes(mesh) or not cfg.fsdp:
        return False
    m = axis_sizes(mesh)["model"]
    if cfg.n_experts % m or m == 1:
        return False
    n, chips = current_global_batch(), mesh_chips(mesh)
    if n is None:
        raise ValueError("a MoE layer on a mesh needs the global batch: "
                         "use_mesh(mesh, global_batch=n)")
    return n % chips == 0 and n >= chips


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor leaf's local shard (differentiable); a plain tensor is
    taken to be the shard already."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _pmean(aux: torch.Tensor) -> torch.Tensor:
    """The mean of ``aux`` over every rank of the mesh.  Its gradient
    flows to this rank's own ``aux`` unchanged: a data-parallel step that
    averages its ranks' gradients then differentiates the mean."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    total = funcol.all_reduce(aux.detach(), "sum", dist.group.WORLD)
    return aux + (total / dist.get_world_size() - aux.detach())


def moe_apply_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b_loc, S, D], this rank's tokens -> (out [b_loc, S, D], the aux
    loss's mean over the mesh)."""
    import torch.distributed._functional_collectives as funcol
    mesh = current_mesh()
    group = mesh["model"]
    m = group.size()
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    e_loc = e // m
    router, wi, wg, wo = (_local(w) for w in (p.router, p.wi, p.wg, p.wo))
    if wi.shape[0] != e_loc:
        raise ValueError(f"expert banks of {wi.shape[0]} experts on a rank "
                         f"of a {m}-way 'model' axis ({e} experts)")
    dev = x.device
    t_loc = x.shape[0] * x.shape[1]
    xt = x.reshape(t_loc, d)
    probs, gate, expert = top_k(router, xt, cfg)
    aux = _pmean(aux_loss(probs, expert, e))

    flat_e = expert.reshape(-1)                                   # [t*k]
    dest = flat_e // e_loc                                        # its rank
    cap_send = max(8, -(-int(t_loc * k * cfg.capacity_factor / m) // 8) * 8)
    slot, keep = rank_by(dest, m, cap_send)
    tok_idx = torch.arange(t_loc, device=dev).repeat_interleave(k)
    dump = m * cap_send                                # +1 overflow slot
    slot_s = torch.where(keep, slot, dump)
    send = torch.zeros((dump + 1, d), dtype=x.dtype, device=dev).index_add(
        0, slot_s, torch.where(keep[:, None], xt[tok_idx], 0))
    send_le = torch.zeros(dump + 1, dtype=torch.int64, device=dev).scatter(
        0, slot_s, torch.where(keep, flat_e % e_loc + 1, 0))

    # dispatch all-to-all over the expert axis: block j goes to rank j
    rt = funcol.all_to_all_single_autograd(send[:dump], None, None, group)
    rle = funcol.all_to_all_single(send_le[:dump], None, None, group)

    # second-stage bucket by local expert; padding (id 0) takes no slot
    cap2 = max(8, -(-int(m * cap_send * 1.0 / e_loc) // 8) * 8) * 2
    real = rle > 0
    slot2, keep2 = rank_by(torch.where(real, rle - 1, e_loc), e_loc + 1,
                           cap2)
    keep2 = keep2 & real
    dump2 = e_loc * cap2
    buf = torch.zeros((dump2 + 1, d), dtype=x.dtype, device=dev).index_add(
        0, torch.where(keep2, slot2, dump2),
        torch.where(keep2[:, None], rt, 0))
    buf = buf[:dump2].reshape(e_loc, cap2, d)

    hg = _expert_product(buf, wg)
    hi = _expert_product(buf, wi)
    hh = (silu(hg) * hi).to(x.dtype)
    yb = _expert_product(hh, wo).to(x.dtype)

    # un-bucket, return all-to-all, combine in (token, choice) order
    y_rt = torch.where(keep2[:, None],
                       yb.reshape(dump2, d)[slot2.clamp(max=dump2 - 1)], 0)
    y_back = funcol.all_to_all_single_autograd(y_rt, None, None, group)
    y_flat = torch.where(keep[:, None], y_back[slot.clamp(max=dump - 1)], 0)
    w = torch.where(keep, gate.reshape(-1), 0.0)[:, None]
    out = combine(y_flat.float() * w, k)
    return out.reshape(x.shape).to(x.dtype), aux
