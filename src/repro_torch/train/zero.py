"""AdamW over a mesh with ZeRO-sharded moments: the update the reference's
dry run compiles for a train cell (its ``_opt_specs``: the moments in
``sharding.opt_state_specs``'s layout, the parameters in
``param_specs``'s), written out for the port's rank-local step.

The parameters are DTensors (``sharding.distribute``), each used through
an all-gather (``fsdp_params``), so after the backward pass a parameter's
local gradient is summed over the mesh axes that shard it and partial over
the others.  Per leaf (``models/weights.py::leaf_map``: a layer stack's
rows stacked, as the moments are):

  1. the gradient goes to the moments' layout: DTensor's redistribution
     from ``Partial`` reduce-scatters it over the data axes (an
     all-reduce over an axis the moments replicate), and it is divided
     by the world size: the mean of the ranks' gradients, each rank's
     gradient being the world size times its share of the global loss's
     (``loss.lm_loss(replicas=)``), whatever the layout;
  2. the global norm: every rank's squares, divided by the number of
     ranks holding the same piece, all-reduced over the world;
  3. ``optim._adamw`` on the rank's pieces of the parameter, moments and
     gradient (the parameter's piece is a local slice of its shard);
  4. the updated pieces are all-gathered back into the parameter's
     shard.

Every collective is a functional one (``roofline/collectives.py`` counts
them).  Gradient compression is not supported here.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from ..models.weights import leaf_map
from ..sharding.rules import P, from_local, local_slices, placements
from . import optim


def _dt(local: torch.Tensor, mesh, pl, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's shard
    and its placements."""
    from torch.distributed.tensor import DTensor
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def moments(cfg: optim.AdamWConfig, params: torch.nn.Module,
            mspecs: Mapping[str, P], mesh) -> optim.OptState:
    """``optim.init``'s state with ``mu``/``nu`` as DTensors in
    ``mspecs``' layout (each rank allocates only its piece)."""
    if cfg.compress:
        raise NotImplementedError("zero.moments: gradient compression on "
                                  "a mesh is not supported")
    dev = next(params.parameters()).device

    def zeros(key, shape):
        local = [s.stop - s.start
                 for s in local_slices(shape, mspecs[key], mesh)]
        return from_local(torch.zeros(local, dtype=torch.float32,
                                      device=dev), mspecs[key], mesh, shape)
    leaves = leaf_map(params, params.cfg)
    return optim.OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: zeros(k, leaf.shape) for k, leaf in leaves.items()},
        nu={k: zeros(k, leaf.shape) for k, leaf in leaves.items()},
        err={k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in leaves})


@torch.no_grad()
def update(cfg: optim.AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: optim.OptState, params: torch.nn.Module, *,
           pspecs: Mapping[str, P], mesh
           ) -> Tuple[torch.nn.Module, optim.OptState,
                      Dict[str, torch.Tensor]]:
    """``optim.update``'s step on a mesh (the module docstring)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Shard
    world = dist.get_world_size()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    leaves = leaf_map(params, params.cfg)
    pieces = {}
    sq = []
    for key, leaf in leaves.items():
        ppl = placements(pspecs[key], mesh)
        mpl = state.mu[key].placements
        rows = [grads[n].to_local() for n in leaf.names]
        g = torch.stack(rows) if leaf.stacked else rows[0]
        gpl = [pl if isinstance(pl, Shard) else Partial() for pl in ppl]
        g = _dt(g, mesh, gpl, leaf.shape).redistribute(mesh, mpl)
        g = g.to_local().float() / world
        reps = math.prod(n for n, pl in zip(sizes.values(), mpl)
                         if not isinstance(pl, Shard))
        sq.append(torch.sum(torch.square(g)) / reps)
        pieces[key] = (ppl, mpl, g)
    gnorm = torch.sqrt(funcol.all_reduce(torch.stack(sq).sum(), "sum",
                                         dist.group.WORLD))
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp_min(gnorm, 1e-12), max=1.0)

    step = state.step + 1
    lr = optim.lr_schedule(cfg, step)
    sf = step.float()
    b1c = 1 - torch.full_like(sf, cfg.b1) ** sf
    b2c = 1 - torch.full_like(sf, cfg.b2) ** sf
    for key, leaf in leaves.items():
        ppl, mpl, g = pieces[key]
        rows = [p.to_local() for p in leaf.params]
        w = torch.stack(rows) if leaf.stacked else rows[0].clone()
        w = _dt(w, mesh, ppl, leaf.shape).redistribute(
            mesh, mpl).to_local().contiguous()
        optim._adamw(cfg, w, g, state.mu[key].to_local(),
                     state.nu[key].to_local(), lr, b1c, b2c, scale,
                     decay=leaf.ndim >= 2)
        w = _dt(w, mesh, mpl, leaf.shape).redistribute(mesh, ppl).to_local()
        for r, new in zip(rows, leaf.rows(w)):
            r.copy_(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, optim.OptState(step, state.mu, state.nu, state.err), \
        metrics

