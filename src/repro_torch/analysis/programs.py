"""Recorded-program sweep for the op pass (port of
``src/repro/analysis/programs.py``).

``iter_traces`` yields a ``ProgramTrace`` for every registry scenario x
program kind — the serial runner (``runners.traced_ops``: the loop
``get_runner(meta, "single")`` builds), the fleet chunk
(``make_fleet_chunk``, one per static policy signature: the routing /
traffic / placement combinations a cohort specializes on), and the
streaming refill (``core.streaming.make_refill``).  Where the reference
traces abstractly, the port runs each program for real, for its first
``CHUNK_STEPS`` events, on a device the caller names: the ops a run
dispatches are the program.

``doctored_trace`` builds small programs that VIOLATE each rule; the
falsifiability tests (tests/test_torch_torchcheck.py) and the CLI's
``--seed`` flag both use it to prove every checker fires.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import runners
from ..api.fleet import STATIC_FIELDS
from ..core.engine import init_fleet_carry, make_consts, make_fleet_chunk
from ..core.policies import as_policy_arrays, policy_fields
from ..core.streaming import STREAM_FIELDS, make_refill
from ..device import resolve
from .checkers import ProgramTrace
from .op_walk import OpRecorder, carry_leaves

FLEET_WIDTH = 4        # lanes of the fleet and refill programs
CHUNK_STEPS = 32       # the events each loop program runs

_SCN_CACHE: Dict[Tuple[str, str], tuple] = {}


def scenario_consts(name: str, device=None):
    """(consts, meta) of a registry scenario on ``device`` (``None`` =
    CUDA), cached per process: the host-side build (route DFS etc.)
    dominates a sweep otherwise."""
    dev = resolve(device)
    key = (name, str(dev))
    if key not in _SCN_CACHE:
        from ..scenarios import get_scenario
        setup = get_scenario(name).build(dev)
        _SCN_CACHE[key] = make_consts(setup, dev)
    return _SCN_CACHE[key]


def cache_clear() -> None:
    _SCN_CACHE.clear()


def axes_of(consts, meta) -> Dict[str, int]:
    return {
        "jobs": int(consts.job_valid.shape[-1]),
        "tasks": int(consts.task_job.shape[-1]),
        "packets": int(consts.pkt_job.shape[-1]),
        "links": int(meta.n_links),
        "vms": int(meta.n_vms),
    }


def static_sigs() -> List[Tuple[int, ...]]:
    """Every static policy signature the fleet specializes on: the cross
    product of the registered choices of the STATIC_FIELDS axes (routing
    x traffic x placement = 2*2*3 = 12), derived from the policy registry
    so a new branch value widens the sweep by itself."""
    fields = {f.name: f for f in policy_fields()}
    per_axis = [sorted((fields[n].choices or {n: fields[n].default}).values())
                for n in STATIC_FIELDS]
    return [tuple(sig) for sig in itertools.product(*per_axis)]


def sig_label(sig: Sequence[int]) -> str:
    fields = {f.name: f for f in policy_fields()}
    return "-".join(fields[n].choice_name(v)
                    for n, v in zip(STATIC_FIELDS, sig))


def _events(carry) -> int:
    return int(carry[0].steps.max())


def trace_serial(name: str, device=None,
                 events: int = CHUNK_STEPS) -> ProgramTrace:
    """The serial runner's loop, its first ``events`` events, via the
    ``runners.traced_ops`` hook under the default policy."""
    consts, meta = scenario_consts(name, device)
    ops, carry, n = runners.traced_ops(meta, consts, as_policy_arrays(None),
                                       events)
    return ProgramTrace(
        key=f"{name}/serial", kind="serial", scenario=name, meta=meta,
        ops=ops, carry=carry_leaves(carry), axes=axes_of(consts, meta),
        events=n)


def fleet_policies(width: int) -> Dict[str, np.ndarray]:
    """The lane-varying policy fields of a fleet cohort: the registered
    defaults, seeds 0..W-1."""
    pol = {k: np.full(width, int(v), np.int32)
           for k, v in as_policy_arrays(None).items()
           if k not in STATIC_FIELDS}
    pol["seed"] = np.arange(width, dtype=np.int32)
    return pol


def trace_fleet(name: str, sig: Tuple[int, ...], device=None,
                width: int = FLEET_WIDTH,
                chunk_steps: int = CHUNK_STEPS) -> ProgramTrace:
    """One fleet chunk from the cohort's t=0 carry: static fields closed
    over as Python ints (one branch each), lane-varying ones as [W]
    arrays."""
    consts, meta = scenario_consts(name, device)
    chunk = make_fleet_chunk(meta, dict(zip(STATIC_FIELDS, sig)),
                             chunk_steps)
    carry0 = init_fleet_carry(consts, meta, width)
    rec = OpRecorder()
    with rec:
        carry = chunk(consts, fleet_policies(width), carry0)
    return ProgramTrace(
        key=f"{name}/fleet/{sig_label(sig)}", kind="fleet", scenario=name,
        meta=meta, ops=rec.ops, carry=carry_leaves(carry),
        axes=axes_of(consts, meta), events=_events(carry), sig=tuple(sig))


def trace_refill(name: str, device=None,
                 width: int = FLEET_WIDTH) -> ProgramTrace:
    """The streaming refill of this scenario's meta: streamed consts
    leaves carry a [W] lane axis, everything else is shared, as
    ``Experiment.run_stream`` calls it; lane 0 refills job 0's slot."""
    consts, meta = scenario_consts(name, device)
    axes = axes_of(consts, meta)
    dev = consts.link_bw.device
    vconsts = consts._replace(**{
        f: getattr(consts, f).expand(width, *getattr(consts, f).shape)
        .contiguous() for f in STREAM_FIELDS})
    carry0 = init_fleet_carry(consts, meta, width)
    lane = torch.arange(width, device=dev) == 0
    job_m = lane[:, None] & (torch.arange(axes["jobs"], device=dev) == 0)
    task_m = lane[:, None] & (consts.task_job == 0)[None]
    pkt_m = lane[:, None] & (consts.pkt_job == 0)[None]
    rec = OpRecorder()
    with rec:
        make_refill(meta)(vconsts, carry0, job_m, task_m, pkt_m, lane)
    return ProgramTrace(
        key=f"{name}/refill", kind="refill", scenario=name, meta=meta,
        ops=rec.ops, carry=None, axes=axes, expect_loop=False,
        expect_host_read=False)


def iter_traces(scenarios: Optional[Sequence[str]] = None,
                sigs: Optional[Sequence[Tuple[int, ...]]] = None,
                kinds: Sequence[str] = ("serial", "fleet", "refill"),
                device=None, width: int = FLEET_WIDTH,
                chunk_steps: int = CHUNK_STEPS,
                progress: Optional[Callable[[str], None]] = None
                ) -> Iterator[ProgramTrace]:
    """The full sweep: every registry scenario x kind (x static signature
    for the fleet kind) on ``device`` (``None`` = CUDA).  ``progress`` (a
    callable taking one string) gets a line per program."""
    if scenarios is None:
        from ..scenarios import list_scenarios
        scenarios = list_scenarios()
    if sigs is None:
        sigs = static_sigs()
    for name in scenarios:
        if "serial" in kinds:
            if progress:
                progress(f"run {name}/serial")
            yield trace_serial(name, device, chunk_steps)
        if "fleet" in kinds:
            for sig in sigs:
                if progress:
                    progress(f"run {name}/fleet/{sig_label(sig)}")
                yield trace_fleet(name, sig, device, width, chunk_steps)
        if "refill" in kinds:
            if progress:
                progress(f"run {name}/refill")
            yield trace_refill(name, device, width)


# --- doctored programs: one per rule, used to PROVE the checkers fire ----

_AXES = {"tasks": 8, "jobs": 2, "links": 4, "vms": 2}


def _loop(body, w: torch.Tensor, events: int = 3,
          host_read: bool = True) -> Tuple[list, torch.Tensor]:
    """``events`` events of ``w = body(w)`` under an ``OpRecorder``, each
    event behind a host read of a device flag (the engine's done check)
    unless ``host_read`` is off."""
    rec = OpRecorder()
    with rec:
        for _ in range(events):
            if host_read and bool((w != w).all()):   # never done
                break
            w = body(w)
    return rec.ops, w


def _trace(rule: str, ops, w: torch.Tensor, n_packets: int,
           events: int = 3) -> ProgramTrace:
    return ProgramTrace(
        key=f"doctored/{rule}", kind="doctored", scenario="doctored",
        meta="doctored-meta", ops=ops, carry=carry_leaves([w]),
        axes={"packets": n_packets, **_AXES}, events=events)


def doctored_trace(rule: str, n_packets: int = 64) -> ProgramTrace:
    """A minimal program that VIOLATES ``rule`` (falsifiability: a checker
    that cannot be tripped is not checking anything), on the CPU.  Axes
    mimic a tiny scenario with ``n_packets`` packets."""
    w = torch.linspace(1.0, 2.0, n_packets)
    if rule == "sort-in-loop":
        ops, w = _loop(lambda v: torch.sort(v).values, w)
    elif rule == "scatter-in-loop":
        idx = torch.arange(n_packets).flip(0)
        ops, w = _loop(lambda v: v.scatter(0, idx, v), w)   # full width
    elif rule == "dtype-drift":
        ops, w = _loop(lambda v: v.to(torch.float32).to(torch.float16),
                       w.to(torch.float16))                 # f16 -> f32
    elif rule == "batched-cond":
        # no host read anywhere: every "fast path" is a select
        ops, w = _loop(lambda v: torch.where(v > 0, v * 2.0, v), w,
                       host_read=False)
    elif rule == "carry-stability":
        raise ValueError("carry-stability needs two programs: use "
                         "clean_trace() and clean_trace(n_packets=96)")
    else:
        raise ValueError(f"no doctored program for rule {rule!r}")
    return _trace(rule, ops, w, n_packets)


def clean_trace(n_packets: int = 64) -> ProgramTrace:
    """The doctored programs' innocent twin: a loop that keeps its host
    read of a device flag, touches no packet-axis sort or scatter and
    stays float32 — must pass every checker."""
    ops, w = _loop(lambda v: v + 1.0, torch.linspace(1.0, 2.0, n_packets))
    return _trace("clean", ops, w, n_packets)
