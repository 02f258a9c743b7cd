"""Checkers over the recorded ops of engine programs (port of
``src/repro/analysis/checkers.py``).

Each checker takes a ``ProgramTrace`` (the ops of a program's first
events, its carry, and the axis sizes needed to interpret them) and
returns ``Finding``s; ``budget_counts`` extracts the per-program op counts
and carry signature that land in ``experiments/TORCH_OP_BUDGET.json``.
``analyze`` drives all of it over a sweep of traces, including the
cross-program carry-stability check (torchcheck:carry-stability).

The checkers operate on what ran, not on source: a sort that sneaks into
the loop trips torchcheck:sort-in-loop no matter which file introduced
it, with the op's source in the finding.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .op_walk import Leaf, OpRecord, carry_signature, itemsize
from .rules import Finding

SORT_OPS = ("sort", "argsort")
SCATTER_OPS = ("scatter", "scatter_add", "scatter_reduce", "index_put",
               "index_add")

# budgeted ops: counted over the loop's events per program.  An INCREASE
# over the committed baseline fails the gate for every op except
# "_local_scalar_dense" (a host read of a device flag), where a DECREASE
# fails instead: losing one means a skip-when-idle fast path now runs both
# branches (torchcheck:batched-cond).  "_to_copy" counts casts on one
# device; copies between the host and a device are counted apart
# (``host_copies``), as a run on the CPU dispatches none.
WATCHED = SORT_OPS + SCATTER_OPS + (
    "gather", "index", "where", "_to_copy", "_local_scalar_dense",
    "nonzero")
HOST_READ = "_local_scalar_dense"

# the two functions that run float64 on purpose (recorded divergences)
WIDENING_OK = ("core/fp.py::fma32", "core/engine.py::_sum32")

_FLOATS = ("float16", "bfloat16", "float32", "float64")


@dataclasses.dataclass
class ProgramTrace:
    """One engine program's recorded ops plus the context checkers need."""
    key: str                    # ledger key, e.g. "paper-fabric/serial"
    kind: str                   # "serial" | "fleet" | "refill" | "doctored"
    scenario: str
    meta: object                # hashable SimMeta (or a test sentinel)
    ops: List[OpRecord]         # the ops of the loop's events (the whole
    #                             program when it has no loop)
    carry: Optional[List[Leaf]]  # the loop carry's leaves (None: no loop)
    axes: Dict[str, int]        # {"packets": n, "tasks": n, "jobs": n, ...}
    events: int = 0             # loop events the ops cover
    sig: Optional[Tuple[int, ...]] = None   # fleet static signature
    expect_loop: bool = True    # engine programs run at least one event
    expect_host_read: bool = True  # ... and read a device flag


def _where(trace: ProgramTrace, i: int, op: OpRecord) -> str:
    return f"{trace.key} @ op #{i} {op.overload} [{op.source}]"


# --- torchcheck:sort-in-loop / torchcheck:scatter-in-loop -----------------

def check_forbidden(trace: ProgramTrace) -> List[Finding]:
    """Packet-axis sorts and full-width packet-axis scatters among the
    loop's ops.  Sorts over the job/vm/task axes and single-element pops
    or link segment-sums do NOT match: the budget counts them."""
    n_pkt = trace.axes.get("packets", -1)
    out: List[Finding] = []
    for i, op in enumerate(trace.ops):
        if op.name in SORT_OPS:
            if any(n_pkt in shape for shape, _, _ in op.inputs):
                out.append(Finding(
                    rule="sort-in-loop", where=_where(trace, i, op),
                    message=f"sort over the packet axis (n={n_pkt}) "
                            "among the engine loop's ops",
                    key=f"sort-in-loop:{op.function}:{op.name}"))
        elif op.name in SCATTER_OPS and len(op.inputs) >= 3:
            # the updates are the last tensor argument (scatter's src,
            # index_put's values, index_add's source)
            upd = op.inputs[-1][0]
            if n_pkt in upd:
                out.append(Finding(
                    rule="scatter-in-loop", where=_where(trace, i, op),
                    message=f"{op.name} with full packet-axis updates "
                            f"{upd} among the engine loop's ops",
                    key=f"scatter-in-loop:{op.function}:{op.name}"))
    return out


# --- torchcheck:dtype-drift -----------------------------------------------

def _widening(op: OpRecord) -> Optional[Tuple[str, str]]:
    if op.name != "_to_copy" or op.host_copy or not op.inputs:
        return None
    src, dst = op.inputs[0][1], op.outputs[0][1]
    if src in _FLOATS and dst in _FLOATS and \
            itemsize(dst) > itemsize(src):
        return src, dst
    return None


def int64_casts(ops: Sequence[OpRecord]) -> int:
    """Same-device casts to int64 (PyTorch's index dtype): counted."""
    return sum(1 for op in ops if op.name == "_to_copy" and not op.host_copy
               and op.outputs and op.outputs[0][1] == "int64"
               and op.inputs[0][1] != "int64")


def check_dtype_drift(trace: ProgramTrace) -> List[Finding]:
    """64-bit carry leaves, and widening float casts among the loop's ops
    outside ``WIDENING_OK``."""
    out: List[Finding] = []
    for i, (shape, dtype) in enumerate(trace.carry or ()):
        if dtype.endswith("64") or dtype == "complex128":
            out.append(Finding(
                rule="dtype-drift", where=f"{trace.key} @ carry[{i}]",
                message=f"{dtype} leaf {shape} in the loop carry",
                key=f"dtype-drift:{trace.kind}:carry"))
    for i, op in enumerate(trace.ops):
        w = _widening(op)
        if w and not any(op.function == ok or op.function.startswith(
                ok + ".") for ok in WIDENING_OK):
            out.append(Finding(
                rule="dtype-drift", where=_where(trace, i, op),
                message=f"widening cast {w[0]} -> {w[1]} among the engine "
                        "loop's ops",
                key=f"dtype-drift:{op.function}:{w[0]}->{w[1]}"))
    return out


# --- torchcheck:batched-cond ----------------------------------------------

def check_batched_cond(trace: ProgramTrace) -> List[Finding]:
    """The port's fast paths are Python branches on a device flag, each a
    ``_local_scalar_dense``.  The serial loop and the fleet chunk read
    their done flags every event; a loop with no host read at all means
    every fast path runs both branches.  Drifts smaller than some-vs-none
    are caught by the budget's inverted ``_local_scalar_dense`` entry."""
    if not trace.expect_host_read or not trace.expect_loop:
        return []
    if any(op.name == HOST_READ for op in trace.ops):
        return []
    return [Finding(
        rule="batched-cond", where=f"{trace.key} @ loop",
        message="the engine loop reads no device flag on the host at all: "
                "every skip-when-idle fast path runs both branches",
        key=f"batched-cond:{trace.key}")]


# --- torchcheck:carry-stability -------------------------------------------

def check_carry_stability(traces: Sequence[ProgramTrace]) -> List[Finding]:
    """Programs sharing a (SimMeta, kind) must agree on the loop carry
    structure: a scenario whose workload seed (not geometry) changed may
    never change the carry."""
    groups: Dict[Tuple, Tuple[str, Tuple]] = {}
    out: List[Finding] = []
    for trace in traces:
        if trace.carry is None:
            continue
        sig = carry_signature(trace.carry)
        group = (trace.meta, trace.kind)
        prev = groups.get(group)
        if prev is None:
            groups[group] = (trace.key, sig)
        elif prev[1] != sig:
            out.append(Finding(
                rule="carry-stability", where=f"{trace.key} vs {prev[0]}",
                message=f"same SimMeta/kind but different loop carry: "
                        f"{sig} vs {prev[1]}",
                key=f"carry-stability:{trace.kind}:{trace.scenario}"))
    return out


# --- budget extraction ----------------------------------------------------

def budget_counts(trace: ProgramTrace) -> dict:
    """The committed-ledger row for one program: watched op counts over
    the loop's events (the whole program when loop-free), the total op
    count (host copies left out), host copies, int64 casts, events and
    the carry signature."""
    c: Counter = Counter()
    host = 0
    for op in trace.ops:
        if op.host_copy:
            host += 1
        elif op.name in WATCHED:
            c[op.name] += 1
    row = {"loop": {k: int(c.get(k, 0)) for k in WATCHED},
           "ops": len(trace.ops) - host, "host_copies": host,
           "int64_casts": int64_casts(trace.ops), "events": trace.events}
    if trace.carry is not None:
        leaves, nbytes, digest = carry_signature(trace.carry)
        row["carry"] = {"leaves": leaves, "bytes": nbytes, "sig": digest}
    return row


def analyze(traces: Sequence[ProgramTrace]) -> Tuple[List[Finding], dict]:
    """Run every per-program checker plus the cross-program one.  Returns
    ``(findings, programs)`` where ``programs`` maps ledger key -> budget
    row."""
    findings: List[Finding] = []
    programs: dict = {}
    for trace in traces:
        if trace.expect_loop and trace.events == 0:
            findings.append(Finding(
                rule="carry-stability", where=trace.key,
                message="expected an engine loop but the program ran no "
                        "event",
                key=f"carry-stability:no-loop:{trace.key}"))
        findings += check_forbidden(trace)
        findings += check_dtype_drift(trace)
        findings += check_batched_cond(trace)
        programs[trace.key] = budget_counts(trace)
    findings += check_carry_stability(traces)
    return findings, programs
