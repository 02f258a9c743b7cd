"""Logical -> physical sharding rules: port of
``src/repro/sharding/rules.py``.

The spec trees are the reference's, keyed on the reference's param-tree
leaves (``models/weights.py::leaf_map``: ``layers/attn/wq``,
``period/1/moe/wi``): batch and data parallel over ``("pod", "data")``,
parameters over ``"model"``:

  * every weight matrix shards its feature-expanding dim over ``"model"``
    (wq/wk/wv/wi/wg: the out-dim; wo: the in-dim);
  * embeddings shard the vocab dim;
  * MoE expert banks shard the expert dim (expert parallelism);
  * Mamba shards d_inner;
  * norms and scalars replicate;
  * a stacked leaf's leading dims (the layer stack, the hybrid's period
    axis) are never sharded.

A spec is a ``P``: one entry a dimension, an axis name, a tuple of names
or ``None``, as ``jax.sharding.PartitionSpec``.  A ``mesh`` argument is a
``DeviceMesh`` or a shape-only stand-in (``sharding/mesh.py::axis_sizes``).

Placing data: ``placements(spec, mesh)`` is one ``Shard(d)`` or
``Replicate()`` a mesh dimension; ``distribute(tree, specs, mesh)`` makes
the stored leaves DTensors whose local shards are this rank's slices (no
communication).  The model and engine code then run on rank-local
tensors, as code inside the reference's ``shard_map`` does; the port has
no partitioner, so where the reference's sharding moves data the port
moves it with an explicit functional collective:

  * ``replicate_hint`` of a DTensor all-gathers it at its use (backward:
    a reduce-scatter); ``fsdp_params`` does so over a module's weights
    unless the config's ``fsdp`` is False, the reference's Megatron
    tensor-parallel layout: then the weights stay sharded and the layers
    compute on their local shards (``sharding/tp.py``).

The reference's ``shard_hint`` and ``activation_hint`` only constrain how
GSPMD lays out an activation.  Activations here are already the rank's
own, so they have no counterpart; where the reference's layout splits an
activation (the sequence of a prefill whose batch leaves ``"model"``
idle, the decode query's Dh), ``sharding/tp.py`` does it by hand.

Outside ``sharding.mesh.use_mesh`` both hints return their argument, bit
for bit, and nothing of ``torch.distributed`` is imported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .mesh import axis_sizes, current_mesh

MODEL = "model"


class P(tuple):
    """A partition spec: one entry a dimension (an axis name, a tuple of
    axis names, or ``None``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch axes present in this mesh ("pod" optional)."""
    names = axis_sizes(mesh) if not isinstance(mesh, (tuple, list)) else mesh
    return tuple(a for a in ("pod", "data") if a in names)


# leaf name -> spec of its trailing dims; leading (stack) dims get None
_LEAF_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "tok": (MODEL, None),            # [V, D] vocab parallel
    "w": (None, MODEL),              # unembed [D, V]
    "wq": (None, MODEL), "wk": (None, MODEL), "wv": (None, MODEL),
    "wo": (MODEL, None),
    "wi": (None, MODEL), "wg": (None, MODEL),
    "router": (None, None),
    "in_x": (None, MODEL), "in_z": (None, MODEL),
    "x_proj": (MODEL, None), "dt_proj": (None, MODEL),
    "dt_bias": (MODEL,), "a_log": (MODEL, None), "d_skip": (MODEL,),
    "conv_w": (None, MODEL), "conv_b": (MODEL,),
    "out": (MODEL, None),
    "scale": (None,),
}

# MoE expert banks [E, d_in, d_out]: the expert dim over "model"
_MOE_3D = (MODEL, None, None)


def _leaf_spec(path: Tuple[str, ...], ndim: int) -> P:
    name = path[-1]
    if name in ("wi", "wg", "wo") and ndim >= 3 and "moe" in path:
        trailing = _MOE_3D
    elif name in _LEAF_RULES:
        trailing = _LEAF_RULES[name]
    else:
        trailing = (None,) * ndim
    t = trailing[-ndim:] if len(trailing) > ndim else trailing
    return P(*((None,) * (ndim - len(t)) + tuple(t)))


def _shapes(params: Any) -> Dict[str, Tuple[int, ...]]:
    """{leaf key: the reference leaf's shape} of a port model, or of a
    dict of leaf keys to tensors."""
    if isinstance(params, nn.Module):
        from ..models.weights import leaf_map
        return {k: leaf.shape
                for k, leaf in leaf_map(params, params.cfg).items()}
    return {k: tuple(v.shape) for k, v in params.items()}


def _prod(sizes: Dict[str, int], entry) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes.get(a, 1) for a in axes)


def param_specs(params: Any, mesh=None) -> Dict[str, P]:
    """{leaf key: P} of a port model (or {leaf key: tensor}), over the
    reference leaf's stacked shape.  With ``mesh`` given, a dim that does
    not divide its axes' size falls back to replicated (whisper's vocab
    51865 on a 16-way axis)."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    out = {}
    for key, shape in _shapes(params).items():
        spec = _leaf_spec(tuple(key.split("/")), len(shape))
        out[key] = P(*(a if a is None or not sizes
                       or shape[d] % _prod(sizes, a) == 0 else None
                       for d, a in enumerate(spec)))
    return out


def opt_state_specs(params: Any, mesh) -> Dict[str, P]:
    """ZeRO: the float32 moments additionally shard over the data axes,
    on the first dim (the stack dim included) that divides, on top of the
    parameters' ``"model"`` sharding."""
    sizes = axis_sizes(mesh)
    da = data_axes(mesh)
    dsize = math.prod(sizes[a] for a in da)
    dspec = da if len(da) > 1 else (da[0] if da else None)
    shapes = _shapes(params)
    out = {}
    for key, spec in param_specs(params, mesh).items():
        shape = shapes[key]
        dims = list(spec)
        if len(shape) and dsize > 1:
            for i, n in enumerate(shape):
                if dims[i] is None and n % dsize == 0 and n >= dsize:
                    dims[i] = dspec
                    break
        out[key] = P(*dims)
    return out


def _tree_map(fn, tree: Any, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over dicts (keys sorted as the reference
    flattens them), lists and tuples; the same structure back."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_axes(n: int, mesh) -> Tuple[str, ...]:
    """The axes a batch of ``n`` rows goes over: the longest prefix of
    ("pod", "data", "model") whose size divides it (none at all when
    not even the first does)."""
    sizes = axis_sizes(mesh)
    t = tuple(a for a in ("pod", "data", "model") if a in sizes)
    while t:
        k = math.prod(sizes[a] for a in t)
        if n % k == 0 and n >= k:
            break
        t = t[:-1]
    return t


def batch_specs(batch: Any, mesh) -> Any:
    """The batch dim over as many axes as divide it (``batch_axes``):
    ("pod", "data", "model") - the model axis is the ZeRO shard domain
    and a batch axis - falling back to ("pod", "data"), then replication
    (the reference's ``fsdp=True``)."""

    def one(_, leaf):
        if leaf.ndim == 0:
            return P()
        t = batch_axes(leaf.shape[0], mesh)
        if not t:
            return P(*(None,) * leaf.ndim)
        return P(t if len(t) > 1 else t[0], *(None,) * (leaf.ndim - 1))

    return _tree_map(one, batch)


def activation_spec(mesh, ndim: int = 3) -> P:
    da = data_axes(mesh)
    return P(da if len(da) > 1 else (da[0] if da else None),
             *(None,) * (ndim - 1))


def cache_rows(n: int, mesh):
    """The spec entry of a cache's batch of ``n`` rows
    (``cache_specs_tree``): the data axes when their size divides it,
    else ``None``."""
    sizes = axis_sizes(mesh)
    da = data_axes(mesh)
    data_size = math.prod(sizes[a] for a in da)
    if n % max(data_size, 1) or n < data_size:
        return None
    return da if len(da) > 1 else (da[0] if da else None)


def cache_specs_tree(cache: Any, mesh, *, batch_axis_of: int = 1) -> Any:
    """The decode cache's sharding: batch over the data axes (when it
    divides) and one non-batch dim over ``"model"``, the last one first
    (Dh of a KV cache, N of a Mamba state), else the widest that divides;
    ``len`` and scalars replicate."""
    msize = axis_sizes(mesh).get(MODEL, 1)

    def one(path, leaf):
        if leaf.ndim == 0 or path[-1] == "len":
            return P()
        dims = [None] * leaf.ndim
        b = leaf.shape[batch_axis_of] if leaf.ndim > batch_axis_of else 1
        dims[batch_axis_of] = cache_rows(b, mesh)
        if msize > 1:
            cand = [i for i in range(leaf.ndim - 1, 0, -1)
                    if i != batch_axis_of]
            cand.sort(key=lambda i: (i != leaf.ndim - 1, -leaf.shape[i]))
            for i in cand:
                if leaf.shape[i] % msize == 0 and leaf.shape[i] >= msize:
                    dims[i] = MODEL
                    break
        return P(*dims)

    return _tree_map(one, cache)


# ---------------------------------------------------------------------------
# placing data: DTensors
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> Tuple[Any, ...]:
    """One ``Shard(d)`` or ``Replicate()`` a dimension of the
    ``DeviceMesh``.  A dim over a tuple of axes is split over them in the
    mesh's order, as JAX splits it in the tuple's."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_slices(shape, spec: P, mesh) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of ``shape`` placed by ``spec``."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        chunk, idx = n, 0
        for a in axes:                     # outermost axis first
            if chunk % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {axes}")
            chunk //= sizes[a]
            idx = idx * sizes[a] + coord[a]
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def from_local(local: torch.Tensor, spec: P, mesh, shape):
    """A DTensor of global ``shape`` (contiguous) placed by ``spec``, from
    this rank's shard ``local`` (no communication)."""
    from torch.distributed.tensor import DTensor
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def to_dtensor(t: torch.Tensor, spec: P, mesh):
    """``t`` (the whole tensor, on every rank) as a DTensor placed by
    ``spec``: its local shard is a copy of this rank's slice."""
    return from_local(t[local_slices(t.shape, spec, mesh)].clone(), spec,
                      mesh, t.shape)


class NamedSharding(NamedTuple):
    """A spec on a mesh: the counterpart of
    ``jax.sharding.NamedSharding`` (``checkpoint.restore``'s
    ``shardings``)."""
    mesh: Any
    spec: P


def named(mesh, specs: Any) -> Any:
    """Every ``P`` of a spec tree as a ``NamedSharding`` on ``mesh``."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(named(mesh, v) for v in specs))
    return type(specs)(named(mesh, v) for v in specs)


def row_spec(spec: P, stacked: bool) -> P:
    """A stacked leaf's spec as its per-layer parameter's: the stack dim
    dropped (it is never sharded)."""
    if not stacked:
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"spec {spec} shards a stack dim")
    return P(*spec[1:])


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` with every tensor a DTensor placed by ``specs``: a port
    model (its parameters replaced in place, ``specs`` keyed by leaf as
    ``param_specs`` gives them), or dicts, lists and tuples of tensors
    with a spec tree of the same structure."""
    if isinstance(tree, nn.Module):
        from ..models.weights import leaf_map
        for key, leaf in leaf_map(tree, tree.cfg).items():
            spec = row_spec(specs[key], leaf.stacked)
            for name, p in zip(leaf.names, leaf.params):
                owner, _, attr = name.rpartition(".")
                mod = tree.get_submodule(owner) if owner else tree
                setattr(mod, attr, nn.Parameter(
                    to_dtensor(p.detach(), spec, mesh),
                    requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return to_dtensor(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, s, mesh)
                            for v, s in zip(tree, specs)))
    return type(tree)(distribute(v, s, mesh) for v, s in zip(tree, specs))


# ---------------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------------


def replicate_hint(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as the whole tensor on this rank: its local shard,
    all-gathered over each mesh dim that shards it (the backward is the
    reduce-scatter of its gradient: FSDP / ZeRO-3).  A plain tensor, or
    anything outside a mesh, comes back as it is."""
    if current_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    t = x.to_local()
    for i in reversed(range(x.device_mesh.ndim)):  # innermost first
        pl = x.placements[i]
        if isinstance(pl, Shard):
            t = _all_gather_autograd(t, pl.dim,
                                                  (x.device_mesh, i))
        elif not pl.is_replicate():
            raise ValueError(f"replicate_hint: placement {pl}")
    return t


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _all_gather_autograd(t, dim, group):
    """The differentiable functional all-gather along ``dim`` (its newer
    name where this PyTorch has it).  Its backward reduce-scatters the
    gradient of the gathered tensor, which NCCL takes only contiguous;
    PyTorch 2.11's backward hands that gradient on as it arrives, and on
    the card a train step's arrived non-contiguous ("Expected
    input.is_contiguous()"), so it is made contiguous first."""
    import torch.distributed._functional_collectives as funcol
    f = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd
    return _ContiguousGrad.apply(f(t, dim, group))


class _Gathered:
    """A module's parameters and submodules as attributes, each DTensor
    weight all-gathered at its first use (``fsdp_params``): a weight
    the caller never reads moves nothing."""

    def __init__(self, module: nn.Module):
        self._module = module

    def __getattr__(self, name: str):
        v = getattr(self._module, name)
        v = _Gathered(v) if isinstance(v, nn.Module) else replicate_hint(v)
        setattr(self, name, v)
        return v


def fsdp_params(tree: Any, cfg=None) -> Any:
    """``replicate_hint`` over every weight of a module (or a tensor),
    unless ``cfg.fsdp`` is False (Megatron tensor parallelism: the
    weights stay sharded).  Outside a mesh the argument itself comes
    back."""
    if current_mesh() is None or (cfg is not None and not cfg.fsdp):
        return tree
    if isinstance(tree, nn.Module):
        return _Gathered(tree)
    return replicate_hint(tree)
