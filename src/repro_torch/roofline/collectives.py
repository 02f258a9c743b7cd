"""Collective accounting: port of ``src/repro/roofline/hlo.py``.

The reference parses a partitioned XLA program's HLO text for its
collectives.  The port's collectives are the functional ones
(``torch.distributed._functional_collectives``, which DTensor's
redistribution also calls), so ``record_collectives()`` records each one
as it is dispatched: its kind, the bytes of its output (the shape the
reference's parser reads) and its group's size.  That holds on gloo,
NCCL and the fake group of the dry run alike.

``collective_stats(records, num_partitions=)`` applies the reference's
ring formulas unchanged, per participating chip:

  all-reduce      2·S·(n-1)/n     (reduce-scatter + all-gather)
  all-gather        S·(n-1)/n     (S = the full output)
  reduce-scatter    S·(n-1)/n     (S = the full input = output·n)
  all-to-all        S·(n-1)/n
  collective-permute  S           (point to point)

The reference's ``duplicate_fusion_count`` (repeated fusion shapes, a
rough remat indicator) has no counterpart: eager PyTorch has no fusions.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# functional collective op -> the reference's (HLO) kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# functional ops that move nothing
_QUIET = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str                 # the reference's name: "all-gather", ...
    bytes: int                # the output's bytes
    group: Optional[int]      # the group's size (None: num_partitions)


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_moved: Dict[str, float]    # output bytes per kind
    wire_bytes: float                # ring-algorithm wire bytes per chip
    ops: List[dict]

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())


def _group_size(func, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            op = func._opname
            if op not in _QUIET:
                if op not in _KINDS:
                    raise NotImplementedError(
                        f"record_collectives: {func} has no wire formula")
                outs = [t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)]
                self.records.append(CollectiveRecord(
                    kind=_KINDS[op],
                    bytes=sum(t.numel() * t.element_size() for t in outs),
                    group=_group_size(func, args)))
        return out


@contextlib.contextmanager
def record_collectives() -> Iterator[List[CollectiveRecord]]:
    """The functional collectives dispatched inside the block, appended to
    the list it yields."""
    rec = _Recorder()
    with rec:
        yield rec.records


def wire_bytes(kind: str, size: float, n: int) -> float:
    """One collective's ring wire bytes per chip (the module docstring)."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * size * frac
    if kind == "collective-permute":
        return float(size)
    if kind == "reduce-scatter":        # the output is the scattered shard
        return size * n * frac
    return size * frac                  # all-gather, all-to-all


def collective_stats(records: Iterable, *, num_partitions: int = 1
                     ) -> CollectiveStats:
    """Counts, output bytes and wire bytes of ``records``
    (``CollectiveRecord``s, or dicts with ``kind``, ``bytes`` and
    ``group``)."""
    counts: Dict[str, int] = {}
    moved: Dict[str, float] = {}
    wire = 0.0
    ops: List[dict] = []
    for r in records:
        r = r if isinstance(r, dict) else dataclasses.asdict(r)
        kind, size = r["kind"], r["bytes"]
        n = r.get("group") or num_partitions
        w = wire_bytes(kind, size, n)
        counts[kind] = counts.get(kind, 0) + 1
        moved[kind] = moved.get(kind, 0.0) + size
        wire += w
        ops.append({"kind": kind, "bytes": size, "group": n,
                    "wire_bytes": w})
    return CollectiveStats(counts=counts, bytes_moved=moved,
                           wire_bytes=wire, ops=ops)
