"""What one call costs, counted on fake tensors: the port's counterpart of
a compiled XLA artifact's ``cost_analysis()`` and ``memory_analysis()``.

``count(fn, *args)`` runs ``fn`` once under ``FakeTensorMode`` (every
tensor has a shape, a dtype and a device but no data, so nothing is
allocated and no kernel runs) and returns a ``Counts`` of four numbers:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s total.  It
  counts the products (mm, bmm, addmm, convolution, scaled-dot-product
  attention, and their backward), 2 a multiply-add, and nothing else:
  element-wise work (the softmax's and the scan's exps, norms, casts) is
  not counted, where XLA's cost analysis counts both.  No padding is
  added for it.
* **bytes**: each dispatched op's tensor inputs and outputs, summed op by
  op (each op reads its inputs and writes its outputs once, as eager
  runs them; a view moves nothing and counts nothing).
* **peak_bytes**: the most bytes of storage live at once, the arguments'
  included.  A storage is live from the op that makes it until its last
  reference goes (a weak-reference finalizer on the storage), so
  autograd's saved tensors, gradients and the optimizer's state count
  while something holds them.  Each storage is rounded up to the CUDA
  caching allocator's 512-byte block, as ``max_memory_allocated`` counts
  it.
* **ops**: the aten ops dispatched.

Metadata queries that fake tensors route through the dispatcher
(``prim::device`` and the other ``prim`` ops) launch nothing and are not
counted.

Nested in that order, the modes see the ops that reach the dispatcher
below autograd: what eager launches (or would launch) on a device.

``count(..., stop_bytes=n)`` answers only whether the call fits ``n``
bytes: it stops as soon as more are live (the arguments included), and
its ``Counts`` then hold what was counted up to there, with
``complete=False`` and ``peak_bytes`` a lower bound.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# the CUDA caching allocator's block granularity
BLOCK_BYTES = 512


@dataclasses.dataclass(frozen=True)
class Counts:
    flops: float
    bytes: float
    peak_bytes: float
    ops: int
    complete: bool = True

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _rounded(nbytes: int) -> int:
    return -(-nbytes // BLOCK_BYTES) * BLOCK_BYTES


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what this rank holds), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def tensors_of(obj: Any, seen=None):
    """Every tensor reachable from ``obj``: tensors, modules (parameters,
    buffers and their ``.grad``), dicts, lists and tuples (NamedTuples
    included); a DTensor as its local shard."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield _local(obj)
        if obj.grad is not None:
            yield _local(obj.grad)
    elif isinstance(obj, torch.nn.Module):
        for t in (*obj.parameters(), *obj.buffers()):
            yield from tensors_of(t, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors_of(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors_of(v, seen)


class Exceeded(Exception):
    """More bytes live than ``LiveBytes.stop_bytes``."""


class LiveBytes(TorchDispatchMode):
    """A dispatch mode that counts ops and bytes moved, and tracks the
    bytes of live storage (see the module docstring); with ``stop_bytes``
    it raises ``Exceeded`` once more are live."""

    def __init__(self, stop_bytes: float = float("inf")):
        super().__init__()
        self.stop_bytes = stop_bytes
        self.ops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, weakref.finalize] = {}

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until its last reference goes."""
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = _rounded(st.nbytes())
        self.live += n
        self.peak = max(self.peak, self.live)
        if self.live > self.stop_bytes:
            raise Exceeded(self.live)

        def free(key=key, n=n):
            self.live -= n
            self._held.pop(key, None)
        self._held[key] = weakref.finalize(st, free)

    def release(self) -> None:
        """Stop tracking (the finalizers no longer fire)."""
        for f in list(self._held.values()):
            f.detach()
        self._held.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":
            return out
        self.ops += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self.hold(t)
        return out


def _fake_mode_of(args) -> FakeTensorMode:
    from torch._guards import detect_fake_mode
    fake = list(tensors_of(args))
    mode = detect_fake_mode(fake) if fake else None
    if fake and mode is None:
        raise ValueError("count: the arguments must be fake tensors (made "
                         "under a FakeTensorMode)")
    return mode or FakeTensorMode()


def count(fn: Callable, *args, stop_bytes: float = float("inf"),
          **kwargs) -> Tuple[Counts, Any]:
    """``fn(*args, **kwargs)`` once under the fake mode of its arguments
    (a new one when they hold no tensor): ``(Counts, fn's result)``.  The
    arguments' storages are live from the start.  Past ``stop_bytes`` the
    count stops: ``(Counts(complete=False), None)``."""
    mode = _fake_mode_of((args, kwargs))
    live = LiveBytes(stop_bytes)
    flop = FlopCounterMode(display=False)
    out, complete = None, True
    try:
        for t in tensors_of((args, kwargs)):
            live.hold(t)
        with mode, flop, live:
            out = fn(*args, **kwargs)
    except Exceeded:
        complete = False
    finally:
        live.release()
    return Counts(flops=float(flop.get_total_flops()),
                  bytes=float(live.bytes), peak_bytes=float(live.peak),
                  ops=live.ops, complete=complete), out
