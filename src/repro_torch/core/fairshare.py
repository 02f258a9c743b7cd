"""Channel bandwidth allocation.

Port of ``src/repro/core/fairshare.py``.  Every function takes either one
replica (``route_links [N, H]``, ``active [N]``) or a batch of lanes with
a leading axis (``[W, N, H]``, ``[W, N]``, per-lane channel counts
``[W, n_links]``); the link capacities are ``link_bw [n_links]``, shared,
or ``[W, n_links]`` per lane (dead links at 0 under failures).

Paper Eq. 3 (fair share): every channel crossing link i gets l_bw(i)/nc(i);
a channel's rate is the minimum share along its route.  This is what
CloudSimSDN implements and what the paper's use-case uses.

Beyond paper: progressive-filling **max-min water-filling**, which is
Pareto-optimal (Eq. 3 can leave residual capacity on non-bottleneck links).

Float sums: water-filling adds frozen allocations per link with a
scatter-add.  On the CPU it adds in update order, as the reference does;
on CUDA the adds are atomics in no fixed order, so water-fill rates there
may differ from the CPU in the last bits.
"""
from __future__ import annotations

import numpy as np
import torch

TRAFFIC_FAIRSHARE = 0  # paper Eq. 3
TRAFFIC_WATERFILL = 1  # beyond-paper max-min fairness


def _batched(route_links, active, nc=None):
    """Add a lane axis to one replica's inputs; report whether it did."""
    if route_links.dim() == 2:
        return (route_links[None], active[None],
                None if nc is None else nc[None], True)
    return route_links, active, nc, False


def _counts(route_links, mask, n_links):
    """Per-lane count of masked hops per link: int32 [W, n_links]."""
    w = route_links.shape[0]
    m = mask & (route_links >= 0)
    idx = torch.where(m, route_links, 0).reshape(w, -1).long()
    return torch.zeros((w, n_links), dtype=torch.int32,
                       device=route_links.device).scatter_add_(
        1, idx, m.reshape(w, -1).to(torch.int32))


def channel_counts(route_links: torch.Tensor, active: torch.Tensor,
                   n_links: int) -> torch.Tensor:
    """nc(i): number of active channels crossing each directed link.

    route_links: int [..., N, H] link ids (-1 pad); active: bool [..., N]
    """
    rl, act, _, single = _batched(route_links, active)
    nc = _counts(rl, act[..., None], n_links)
    return nc[0] if single else nc


def eq3_rates(route_links: torch.Tensor, active: torch.Tensor,
              link_bw: torch.Tensor, intra_bw: float,
              nc: torch.Tensor | None = None) -> torch.Tensor:
    """Paper Eq. 3 rate for every packet (0 for inactive).

    Packets with an empty route (src host == dst host) move at ``intra_bw``.
    ``nc`` takes the per-link channel counts the engine carries; ``None``
    recomputes them here.
    """
    rl, act, nc, single = _batched(route_links, active, nc)
    if nc is None:
        nc = _counts(rl, act[..., None], link_bw.shape[0])
    w = rl.shape[0]
    valid = rl >= 0
    safe = rl.clamp(min=0).long()
    # per-LINK share first, then one gather onto the packet axis
    share_l = link_bw / nc.clamp(min=1).to(link_bw.dtype)        # [W, L]
    share = torch.gather(share_l, 1, safe.reshape(w, -1)).reshape(rl.shape)
    share = torch.where(valid, share, torch.inf)
    bot = share.amin(-1)
    bot = torch.where(torch.isinf(bot),
                      torch.tensor(intra_bw, dtype=link_bw.dtype,
                                   device=bot.device), bot)
    out = torch.where(act, bot, 0.0)
    return out[0] if single else out


def waterfill_rates(route_links: torch.Tensor, active: torch.Tensor,
                    link_bw: torch.Tensor, intra_bw: float,
                    n_iter: int | None = None) -> torch.Tensor:
    """Progressive-filling max-min fair rates.

    Each iteration freezes every flow whose bottleneck link is globally
    saturated at the current fill level; the trip count is fixed at
    ``min(n_links, 32)`` as in the reference, so late iterations are no-ops.
    """
    rl, act, _, single = _batched(route_links, active)
    w, n, h = rl.shape
    n_links = link_bw.shape[-1]
    n_iter = n_iter if n_iter is not None else min(n_links, 32)
    valid = rl >= 0
    safe = rl.clamp(min=0).long().reshape(w, n * h)
    dev = rl.device

    def fill_level(alloc, frozen, live):
        """Per-flow fill level: min over the route of (link residual after
        frozen allocations) / (live flows on the link)."""
        contrib = torch.where(valid & frozen[..., None], alloc[..., None],
                              0.0).reshape(w, n * h)
        used = torch.zeros((w, n_links), dtype=link_bw.dtype,
                           device=dev).scatter_add_(1, safe, contrib)
        resid = (link_bw - used).clamp(min=0.0)
        n_live = torch.zeros((w, n_links), dtype=torch.int32,
                             device=dev).scatter_add_(
            1, safe, (valid & live[..., None]).to(torch.int32).reshape(
                w, n * h))
        share = resid / n_live.clamp(min=1).to(link_bw.dtype)
        share = torch.where(n_live > 0, share, torch.inf)
        per_hop = torch.gather(share, 1, safe).reshape(w, n, h)
        return torch.where(valid, per_hop, torch.inf).amin(-1)

    alloc = torch.zeros((w, n), dtype=link_bw.dtype, device=dev)
    frozen = torch.zeros((w, n), dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        live = act & ~frozen
        level = fill_level(alloc, frozen, live)                   # [W, N]
        glob = torch.where(live, level, torch.inf).amin(-1)       # [W]
        glob = torch.where(torch.isinf(glob), 0.0, glob)
        hit = live & (level <= (glob * (1 + 1e-6))[:, None])
        alloc = torch.where(hit, glob[:, None], alloc)
        frozen = frozen | hit
    # any still-unfrozen live flow (iter cap hit) gets its CURRENT fill
    # level, so no link is ever oversubscribed (the reference's clamp)
    live = act & ~frozen
    alloc = torch.where(live, fill_level(alloc, frozen, live), alloc)
    # intra-host flows
    empty = ~valid.any(-1)
    alloc = torch.where(act & empty,
                        torch.tensor(intra_bw, dtype=link_bw.dtype,
                                     device=dev), alloc)
    out = torch.where(act, alloc, 0.0)
    return out[0] if single else out


def rates(policy, route_links: torch.Tensor, active: torch.Tensor,
          link_bw: torch.Tensor, intra_bw: float,
          nc: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch on the traffic policy.

    ``policy`` is one int for one replica or for every lane, or one value
    per lane (numpy or a tensor).  Each branch runs only when some lane
    takes it; lanes then select their own branch's rates, as the
    reference's vmapped ``lax.cond`` does."""
    pol = np.asarray(policy.cpu() if torch.is_tensor(policy) else policy)
    wf = pol == TRAFFIC_WATERFILL
    if not wf.any():
        return eq3_rates(route_links, active, link_bw, intra_bw, nc=nc)
    if wf.all():
        return waterfill_rates(route_links, active, link_bw, intra_bw)
    lane_wf = torch.as_tensor(wf, device=route_links.device)[:, None]
    return torch.where(lane_wf,
                       waterfill_rates(route_links, active, link_bw,
                                       intra_bw),
                       eq3_rates(route_links, active, link_bw, intra_bw,
                                 nc=nc))
