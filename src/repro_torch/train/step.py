"""Train and serve step builders: port of ``src/repro/train/step.py``.

``make_train_step(api, opt_cfg)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``.  The reference's step is a pure function
that the launcher jits; the port's updates the model and the optimizer
state in place (``optim.update``) and returns them, so a caller that
needs the starting state again keeps a copy (``copy.deepcopy``).  The
metrics are tensors on the model's device: nothing in a step waits for
the device.

On a mesh (``use_mesh(mesh, global_batch=n)``, ``n`` the batch's rows
over every rank; ``update`` then ``zero.update``) the batch is this
rank's piece: its rows, and, where the rule of the reference's
``activation_hint`` splits the sequence (``tp.sequence_parallel``), its
S/m positions of them, which ``apply`` takes from the whole rows itself;
the step takes the labels of the positions whose logits ``apply``
returned.  The loss is the global batch's (``loss.lm_loss(replicas=)``)
and so is every metric, on every rank.  With ``microbatch`` the
microbatches split each rank's rows, so on a mesh microbatch i holds the
i-th part of every rank's rows where the reference's holds the i-th part
of the global batch: the same rows in another grouping.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from ..models.registry import ModelApi
from ..sharding import tp
from ..sharding.mesh import current_global_batch, current_mesh, use_mesh
from . import optim
from .loss import lm_loss

Batch = Dict[str, torch.Tensor]


def _replicas(rows: int, split: bool) -> int:
    """How many ranks hold this rank's piece of the batch (``rows`` rows,
    with the sequence ``split`` over "model" or whole): the world over
    the number of distinct pieces of the global batch."""
    import torch.distributed as dist
    n = current_global_batch()
    if n is None:
        raise ValueError("a train step on a mesh needs the global batch: "
                         "use_mesh(mesh, global_batch=n)")
    pieces = n * (tp.model_axis()[2] if split else 1) // rows
    world = dist.get_world_size()
    if world % pieces:
        raise ValueError(f"{rows} rows a rank of a global batch of {n} "
                         f"on {world} ranks")
    return world // pieces


def make_train_step(api: ModelApi, opt_cfg: optim.AdamWConfig, *,
                    backend: str = "chunked", remat: bool = True,
                    microbatch: int = 0,
                    update: Callable = optim.update) -> Callable:
    """The data-parallel step on one device or a mesh (the module
    docstring); with ``microbatch`` > 1 the batch is split along its
    leading axis into that many microbatches whose gradients are summed
    in float32 buffers and divided by their count, as the reference sums
    into float32 zeros (a bf16 ``.grad`` accumulated across backward
    passes would round every partial sum to bf16); the metrics are then
    the last microbatch's and the loss the mean (on a mesh each
    microbatch's global batch is ``n / microbatch``).  ``update`` is the
    optimizer's step (``zero.update`` on a mesh, with the layouts
    bound)."""

    def grads_of(params, batch: Batch) -> Tuple[torch.Tensor, Batch]:
        out = api.apply(params, {k: v for k, v in batch.items()
                                 if k != "labels"},
                        backend=backend, remat=remat)
        labels = batch["labels"]
        replicas = None
        if current_mesh() is not None:
            # apply split the sequence where its logits are shorter
            split = out["logits"].shape[1] != labels.shape[1]
            replicas = _replicas(labels.shape[0], split)
            if split:
                labels = tp.chunk(labels, 1)
        loss, met = lm_loss(out["logits"], labels,
                            aux_loss=out.get("aux_loss", 0.0),
                            replicas=replicas)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in met.items()}

    def grad_of(p: torch.nn.Parameter) -> torch.Tensor:
        return p.grad if p.grad is not None else torch.zeros_like(p)

    def step(params, opt_state, batch: Batch):
        params.zero_grad(set_to_none=True)
        if microbatch and microbatch > 1:
            mesh, n = current_mesh(), current_global_batch()
            acc: Dict[str, torch.Tensor] = {}
            loss = None
            for i in range(microbatch):
                mb = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                with (use_mesh(mesh, global_batch=n // microbatch)
                      if mesh is not None and n is not None
                      else contextlib.nullcontext()):
                    mb_loss, met = grads_of(params, mb)
                loss = mb_loss if loss is None else loss + mb_loss
                for name, p in params.named_parameters():
                    if name in acc:
                        acc[name].add_(grad_of(p))
                    else:
                        acc[name] = grad_of(p).float()
                    p.grad = None
            loss = loss / microbatch
            grads = {name: g / microbatch for name, g in acc.items()}
        else:
            loss, met = grads_of(params, batch)
            grads = {name: grad_of(p) for name, p in params.named_parameters()}
        params, opt_state, omet = update(opt_cfg, grads, opt_state, params)
        params.zero_grad(set_to_none=True)
        return params, opt_state, {"loss": loss, **met, **omet}

    return step


def make_prefill_step(api: ModelApi, *, backend: str = "chunked") -> Callable:
    def step(params, batch, cache):
        return api.prefill(params, batch, cache, backend=backend)
    return step


def make_decode_step(api: ModelApi) -> Callable:
    def step(params, tokens, cache, batch_extra=None):
        if batch_extra is not None:
            return api.decode_step(params, tokens, cache,
                                   batch_extra=batch_extra)
        return api.decode_step(params, tokens, cache)
    return step
