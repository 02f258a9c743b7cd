"""The aten ops of an engine run, as the op pass's checkers see them
(port of ``src/repro/analysis/jaxpr_walk.py``).

The reference walks a traced jaxpr; eager PyTorch has no program to walk,
so the port RUNS the program (the first events of an engine loop, a
refill) under ``OpRecorder``, a ``TorchDispatchMode`` that records every
aten op that reaches the dispatcher below autograd: its name, its inputs'
and outputs' shapes, dtypes and devices, and its source (the innermost
stack frame inside ``repro_torch``, outside this module).  The engine
loop is the recorded run itself: ``ProgramTrace`` (``checkers.py``) holds
the ops of the loop's events and the carry they leave.

Host reads and copies are classified here, for the budget and for the
card's sync count: ``_local_scalar_dense`` of a CUDA tensor (``bool()``,
``int()``, ``.item()``) waits for the device; a ``_to_copy`` that changes
device (``.cpu()``, ``.to("cuda")``, ``.tolist()``) is a host copy, which
a run on the CPU does not dispatch at all; ``OpRecord.host_sync`` names
the ops after which the host waits.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_PKG = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
_SELF = os.path.realpath(__file__)

Sig = Tuple[Tuple[int, ...], str, str]       # (shape, dtype, device type)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op."""
    name: str                   # overload packet, in-place "_" dropped
    overload: str               # e.g. "aten.scatter_add_.default"
    inputs: Tuple[Sig, ...]     # tensor arguments, in order
    outputs: Tuple[Sig, ...]
    source: str                 # "core/engine.py:742 (_sdn_scan)", the
    #                             function by its qualified name
    non_blocking: bool = False  # a copy's non_blocking flag

    @property
    def function(self) -> str:
        """``file::function`` of the source, without the line."""
        path, _, rest = self.source.partition(":")
        fn = rest.partition("(")[2].rstrip(")")
        return f"{path}::{fn}"

    @property
    def host_copy(self) -> bool:
        """A copy between the host and a device (``_to_copy`` or ``copy_``
        whose output lies on another device than its input)."""
        return (self.name in ("_to_copy", "copy") and bool(self.inputs)
                and bool(self.outputs)
                and self.inputs[-1][2] != self.outputs[0][2])

    @property
    def host_read(self) -> bool:
        """A Python scalar read of a CUDA tensor (``bool()``, ``int()``,
        ``.item()``): the host waits for the device."""
        return (self.name == "_local_scalar_dense"
                and self.inputs[0][2] == "cuda")

    @property
    def host_sync(self) -> bool:
        """An op after which the host waits for the device: a scalar read
        of a CUDA tensor, a blocking copy between the host and a device
        (either way: a pageable upload waits too), or a CUDA ``nonzero``
        (its output size)."""
        return (self.host_read
                or (self.host_copy and not self.non_blocking)
                or (self.name == "nonzero" and self.inputs[0][2] == "cuda"))


def _sig(t: torch.Tensor) -> Sig:
    return tuple(t.shape), str(t.dtype).replace("torch.", ""), t.device.type


_REL: Dict[str, Optional[str]] = {}


def _rel(filename: str) -> Optional[str]:
    """``filename`` relative to the package, or None outside it (or for
    this module), cached per file."""
    if filename not in _REL:
        path = os.path.realpath(filename)
        _REL[filename] = (os.path.relpath(path, _PKG).replace(os.sep, "/")
                          if path.startswith(_PKG + os.sep)
                          and path != _SELF else None)
    return _REL[filename]


def _source() -> str:
    """``path:line (function)`` of the innermost frame in ``repro_torch``
    outside this module, the path relative to the package."""
    f = sys._getframe(2)
    while f is not None:
        rel = _rel(f.f_code.co_filename)
        if rel is not None:
            return f"{rel}:{f.f_lineno} ({f.f_code.co_qualname})"
        f = f.f_back
    return "<outside repro_torch>"


def op_name(func) -> str:
    """The op's overload packet without its in-place underscore:
    ``scatter_add_`` and ``scatter_add`` are one name."""
    name = func._opname
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active (``prim`` ops,
    the metadata queries fake tensors route through the dispatcher, are
    left out)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        ins = tuple(_sig(t) for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor))
        outs = tuple(_sig(t) for t in tree_flatten(out)[0]
                     if isinstance(t, torch.Tensor))
        nb = kwargs.get("non_blocking", False)
        if func._opname == "copy_" and len(args) > 2:
            nb = args[2]
        self.ops.append(OpRecord(
            name=op_name(func), overload=str(func), inputs=ins,
            outputs=outs, source=_source(), non_blocking=bool(nb)))
        return out


Leaf = Tuple[Tuple[int, ...], str]      # (shape, dtype)


def itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def carry_leaves(carry) -> List[Leaf]:
    """The (shape, dtype) of every tensor of a carry (NamedTuples, dicts,
    tuples), in order."""
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_flatten(carry)[0] if isinstance(t, torch.Tensor)]


def carry_signature(leaves: Sequence[Leaf]) -> Tuple[int, int, str]:
    """``(leaves, bytes, sha1-12)`` of a carry's structure — the ledger
    entry that makes silent carry growth (an extra leaf, a widened dtype)
    a visible budget diff."""
    sigs = [(tuple(shape), dtype) for shape, dtype in leaves]
    nbytes = 0
    for shape, dtype in sigs:
        n = itemsize(dtype)
        for d in shape:
            n *= int(d)
        nbytes += n
    digest = hashlib.sha1(repr(sigs).encode()).hexdigest()[:12]
    return len(sigs), nbytes, digest
