"""Megatron tensor parallelism and the sequence split on rank-local
tensors: the arithmetic the reference's GSPMD derives from its spec trees
(``sharding/rules.py``) in the two serving layouts it selects.

* **Tensor parallel (TP)**, ``cfg.fsdp`` False on a mesh (the reference's
  dry run sets it on decode cells).  The weights stay as ``param_specs``
  places them and the layers compute on their local shards:
  column-parallel products (``wq``/``wk``/``wv``/``wi``/``wg``/``in_x``/
  ``in_z``/``dt_proj``: the rank's contiguous run of output columns) and
  row-parallel ones (``wo``/``out``/``x_proj``: its run of input rows,
  then a float32 all-reduce over ``"model"``); the vocab-parallel
  embedding (a masked lookup of the rank's vocab rows, then an
  all-reduce) and unembedding (the rank's float32 logits, then an
  all-gather along V, so every rank returns the whole [B, S, V]).  A leaf
  ``param_specs`` replicates because its dim does not divide (whisper's
  vocab of 51865) is used whole, with no collective.  The cache lies as
  ``cache_specs_tree`` places it: its last dim over ``"model"`` (Dh of
  K/V, N of a Mamba state, Di of its conv state), so the decode
  attention splits Dh (``attention.decode_attention``) and the Mamba
  state is resharded to Di for the scan and back (``state_in``,
  ``state_out``).
* **Sequence parallel (SP)**, a step whose global batch leaves
  ``"model"`` idle (``sequence_parallel``, the rule of the reference's
  ``activation_hint``): each rank takes its S/m positions of its batch
  rows and the weights are gathered at use as in FSDP.  A transformer
  family's prefill takes it, and every family's train forward: K/V are
  all-gathered along S once an attention layer (``gather_seq``, whose
  backward reduce-scatters their gradient), a Mamba block takes its
  convolution's left context from the previous ranks (``prev_rows``) and
  its scan's starting state from theirs (``prefix_state``).

Every collective is a functional one over the ambient mesh's ``"model"``
axis, so ``roofline/collectives.py::record_collectives`` sees it.
Outside ``use_mesh``, or on a weight that is a plain tensor (FSDP has
gathered it), each function here is the one-device operation, bit for
bit: ``column(x, w)`` is ``x @ w``, ``to_cache(t, like)`` is ``t``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .mesh import axis_sizes, current_global_batch, current_mesh

MODEL = "model"


def model_axis() -> Optional[Tuple[object, int, int]]:
    """(group, this rank's index, size) of the ambient mesh's ``"model"``
    axis; ``None`` outside a mesh or on a mesh without one."""
    mesh = current_mesh()
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    if MODEL not in sizes:
        return None
    # the process group, not ``mesh["model"]``: a sub-mesh costs ~0.3 ms
    # a call on the host
    return mesh.get_group(MODEL), mesh.get_local_rank(MODEL), sizes[MODEL]


def active(cfg) -> bool:
    """Megatron TP: ``cfg.fsdp`` is False and a mesh with a ``"model"``
    axis is ambient."""
    return not cfg.fsdp and model_axis() is not None


def local(w: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    if current_mesh() is None:
        return w
    from torch.distributed.tensor import DTensor
    return w.to_local() if isinstance(w, DTensor) else w


def split_dim(w: torch.Tensor) -> Optional[int]:
    """The dim of a DTensor split over ``"model"``; ``None`` for a plain
    tensor or one ``"model"`` replicates."""
    if current_mesh() is None:
        return None
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(w, DTensor) or MODEL not in w.device_mesh.mesh_dim_names:
        return None
    pl = w.placements[w.device_mesh.mesh_dim_names.index(MODEL)]
    return pl.dim if isinstance(pl, Shard) else None


def chunk(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/m of ``t`` along ``dim``, as a DTensor's
    ``Shard(dim)`` over ``"model"`` holds it."""
    _, r, m = model_axis()
    n = t.shape[dim] // m
    return t.narrow(dim, r * n, n)


# Each collective is waited for at once: its result is used by the next
# op anyway, and an ``AsyncCollectiveTensor`` left unwaited sends every op
# that touches it through Python (3x a tick's host time on one rank).


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ``"model"``."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, "sum", model_axis()[0]))


def all_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` of every ``"model"`` rank, concatenated along ``dim`` in rank
    order."""
    import torch.distributed._functional_collectives as funcol
    f = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor          # its newer name where it has one
    return funcol.wait_tensor(f(t.contiguous(), dim % t.ndim,
                                model_axis()[0]))


def world_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank of the default group, without a
    gradient (the loss's and the MoE aux loss's global counts and
    sums)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t.detach(), "sum",
                                                dist.group.WORLD))


class _Valued(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def valued(share: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (a global value, computed without a gradient) whose
    gradient flows into ``share`` (this rank's term of it) unchanged."""
    return _Valued.apply(share, value.detach())


def all_to_all(t: torch.Tensor) -> torch.Tensor:
    """Block j of ``t``'s leading dim (of size m) to rank j; block i of the
    result came from rank i."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single(
        t.contiguous(), None, None, model_axis()[0]))


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] x w [K, N] -> [..., N] float32, with float32
    accumulation (a bf16 product is exact in float32)."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return a @ w
    if a.device.type == "cpu":
        return a.float() @ w.float()
    a2 = a.reshape(1, -1, a.shape[-1])
    return torch.bmm(a2, w[None], out_dtype=torch.float32).reshape(
        *a.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def columns(*pairs: Tuple[torch.Tensor, torch.Tensor]) -> List[torch.Tensor]:
    """``x @ w`` of each (x, w), whole: a column-parallel ``w``'s local
    product is this rank's run of output columns, and the runs of every
    such product travel in one all-gather over ``"model"``."""
    outs = [x @ local(w) for x, w in pairs]
    split = [i for i, (_, w) in enumerate(pairs) if split_dim(w) is not None]
    if not split:
        return outs
    widths = [outs[i].shape[-1] for i in split]
    g = all_gather(torch.cat([outs[i] for i in split], -1)[None], 0)
    for i, part in zip(split, g.split(widths, -1)):   # [m, ..., width]
        outs[i] = part.movedim(0, -2).flatten(-2)
    return outs


def column(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``'s local columns: this rank's run of a column-parallel
    ``w``'s outputs (all of them for a plain or replicated ``w``)."""
    return x @ local(w)


def in_chunk(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The part of a whole ``x`` [..., K] a row-parallel ``w`` [K, N]
    multiplies on this rank: its run of K; all of ``x`` otherwise."""
    return x if split_dim(w) is None else chunk(x, -1)


def row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` this rank's part of the input (``in_chunk``): a
    row-parallel ``w``'s partial products in float32, summed over
    ``"model"`` and cast to ``x``'s dtype; a plain product otherwise."""
    if split_dim(w) is None:
        return x @ local(w)
    return all_reduce(matmul_f32(x, local(w))).to(x.dtype)


def embedding(tokens: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, tok)``; a vocab-parallel ``tok`` looks up the
    tokens in the rank's rows, zeros the others, and sums over
    ``"model"`` (one non-zero term an element: exact)."""
    if split_dim(tok) is None:
        return F.embedding(tokens, local(tok))
    t = local(tok)
    _, r, _ = model_axis()
    idx = tokens - r * t.shape[0]
    inside = (idx >= 0) & (idx < t.shape[0])
    e = F.embedding(idx.clamp(0, t.shape[0] - 1), t)
    return all_reduce(torch.where(inside[..., None], e, 0))


def logits(x: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    """``x @ w`` in float32 (both operands upcast, as ``unembed`` does);
    with ``split`` the local ``w`` holds the rank's vocab columns and the
    logits are all-gathered along V."""
    out = x.float() @ w.float()
    return all_gather(out, -1) if split else out


# ---------------------------------------------------------------------------
# layouts: the cache, the Mamba state, the sequence
# ---------------------------------------------------------------------------


def to_cache(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (this rank's rows, every non-batch dim whole) in the layout of
    the cache view ``like`` (batch first): where ``like`` holds 1/m of a
    dim, this rank's chunk of it; where ``like`` also holds m times the
    rows (the step's batch over ``"model"``, the cache's not), the chunks
    of the ``"model"`` ranks' rows, by one all-to-all.  ``t`` itself when
    the shapes agree."""
    if t.shape == like.shape:
        return t
    _, _, m = model_axis()
    dims = [d for d in range(1, t.ndim) if t.shape[d] != like.shape[d]]
    if len(dims) != 1 or like.shape[dims[0]] * m != t.shape[dims[0]]:
        raise ValueError(f"{tuple(t.shape)} has no layout of "
                         f"{tuple(like.shape)} on a {m}-way 'model' axis")
    d = dims[0]
    if like.shape[0] == t.shape[0]:
        return chunk(t, d)
    if like.shape[0] != m * t.shape[0]:
        raise ValueError(f"{t.shape[0]} rows into a cache of "
                         f"{like.shape[0]}")
    blocks = t.unflatten(d, (m, t.shape[d] // m)).movedim(d, 0)
    return all_to_all(blocks).flatten(0, 1)


def local_rows(v: torch.Tensor, b: int) -> torch.Tensor:
    """This rank's ``b`` rows of a per-row vector ``v`` that
    ``cache_specs_tree`` replicates (the cache's ``len``): its shard over
    the data axes.  ``v`` itself when it has ``b`` rows."""
    if v.shape[0] == b:
        return v
    from .rules import P, cache_rows, local_slices
    mesh = current_mesh()
    out = v[local_slices(v.shape, P(cache_rows(v.shape[0], mesh)), mesh)]
    if out.shape[0] != b:
        raise ValueError(f"{b} rows against a len of {v.shape[0]}")
    return out


def state_in(h: torch.Tensor, di: int, n: int) -> torch.Tensor:
    """A Mamba state view as this rank's [B, di, n] (``di`` its run of
    d_inner): one stored with N over ``"model"`` (the reference's
    ``cache_specs_tree``) by an all-to-all; ``h`` itself when it is that
    already."""
    if h.shape[1:] == (di, n):
        return h
    _, _, m = model_axis()
    b = h.shape[0]
    if h.shape[1:] != (di * m, n // m):
        raise ValueError(f"state {tuple(h.shape)} against {di} channels of "
                         f"{n} a rank")
    blocks = h.reshape(b, m, di, n // m).movedim(1, 0)   # Di block j to j
    return all_to_all(blocks).movedim(0, 2).reshape(b, di, n)


def state_out(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A state [B, di, N] back in the layout of ``like`` (``state_in``'s
    argument) by the inverse all-to-all, or as it is."""
    if like.shape == h.shape:
        return h
    _, _, m = model_axis()
    b, di, n = h.shape
    blocks = h.reshape(b, di, m, n // m).movedim(2, 0)
    return all_to_all(blocks).movedim(0, 1).reshape(b, m * di, n // m)


def sequence_parallel(cfg, seq_len: int) -> bool:
    """Whether a forward over ``seq_len`` positions runs with the sequence
    over ``"model"``, by the rule of the reference's ``activation_hint``:
    an ambient mesh with the step's global batch
    (``use_mesh(global_batch=)``), FSDP weights, a batch that goes over no
    ``"model"`` axis (``rules.batch_axes``) and a sequence that divides
    it.  ``transformer.lm_prefill`` asks it of its prompt; every family's
    train forward asks it of each stack's own sequence (whisper's encoder
    of ``enc_seq``, its decoder of the tokens)."""
    from .rules import batch_axes
    ax = model_axis()
    n = current_global_batch()
    if ax is None or n is None or not cfg.fsdp:
        return False
    return MODEL not in batch_axes(n, current_mesh()) and seq_len % ax[2] == 0


def local_start(n_local: int) -> int:
    """The first position of this rank's ``n_local`` under the split."""
    return model_axis()[1] * n_local


def gather_grad(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``all_gather(t, dim)`` with a gradient: its backward reduce-scatters
    the gathered tensor's gradient over ``"model"`` (a functional
    collective too, so ``record_collectives`` sees both directions)."""
    from .rules import _all_gather_autograd
    return _all_gather_autograd(t.contiguous(), dim % t.ndim,
                                model_axis()[0])


def gather_seq(t: torch.Tensor) -> torch.Tensor:
    """[B, S/m, ...] of every rank as [B, S, ...] (K/V, once a layer),
    with a gradient."""
    return gather_grad(t, 1)


def prev_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` positions before this rank's first under the split, from
    the previous ranks' ``t`` [B, S/m, ...] (zeros before position 0):
    the convolution's left context.  One all-gather of every rank's last
    L = min(n, S/m) rows, with a gradient.  Every rank runs the same ops
    on the gathered rows (only the offset it reads differs), so every
    rank's backward issues the same collectives in the same order."""
    _, r, _ = model_axis()
    tail = min(n, t.shape[1])
    g = gather_grad(t[:, t.shape[1] - tail:][None], 0)  # [m, B, L, ...]
    rows = torch.cat([t.new_zeros((t.shape[0], n, *t.shape[2:])),
                      g.movedim(0, 1).flatten(1, 2)], 1)  # [B, n + m L]
    return rows.narrow(1, r * tail, n)


def prefix_state(decay: torch.Tensor, h: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
    """The state entering this rank's positions of a linear recurrence
    whose rank-j chunk maps a state ``s`` to ``decay_j * s + h_j``
    (``decay``, ``h``: this rank's, [B, ...]) from ``h0`` before position
    0: the previous ranks' chunks composed in order.  One all-gather of
    every rank's (decay, h), with a gradient; every rank composes all
    m - 1 prefixes and takes its own, so that the ranks' graphs, and
    their backward collectives, are the same."""
    _, r, m = model_axis()
    g = gather_grad(torch.stack([decay, h])[None], 0)     # [m, 2, B, ...]
    states = [h0]
    for j in range(m - 1):
        states.append(g[j, 0] * states[-1] + g[j, 1])
    return torch.stack(states)[r]


def from_last_rank(t: torch.Tensor) -> torch.Tensor:
    """``t`` of the last ``"model"`` rank on every rank (the sequence's
    last position): the others add zeros in one all-reduce (exact)."""
    _, r, m = model_axis()
    return all_reduce(t if r == m - 1 else torch.zeros_like(t))
