"""Steady-state streaming ring (DESIGN.md §11).

Port of ``src/repro/core/streaming.py``.  The engine's job/task/packet
tensors are fixed-shape; streaming turns them into a RING: ``RingSpec.slots``
job slots of uniform geometry, each owning a contiguous task block and
packet block.  Completed slots are retired at chunk boundaries and refilled
from an open arrival process (``repro_torch.scenarios.arrivals``), so an
unbounded trace runs in bounded memory: the tensor shapes, and so
``SimMeta``, never change while jobs flow through.

* ``RingSpec``          — slot geometry: the max job shape a slot can hold.
* ``slot_arrays``       — lower ONE job (or an empty pad) into its slot's
                          block of the streamed tensors, mirroring
                          ``mapreduce.build_setup``'s per-job loop exactly.
* ``ring_setup``        — a full ``SimSetup`` with every slot lowered; a
                          finite trace that fits ``slots`` makes this a
                          plain setup ``Experiment.run`` accepts, which is
                          what the identity with ``run_stream`` rests on.
* ``STREAM_FIELDS``     — the ``EngineConsts`` leaves a refill rewrites.
                          Lanes (policies) retire slots at different times,
                          so these leaves gain a leading lane axis, which
                          the engine reads per lane (``engine._take``),
                          while topology / cluster leaves stay shared.
* ``host_stream_arrays`` / ``load_slot`` — the host-side mutable copies of
                          the streamed leaves; a refill rewrites one slot's
                          blocks in numpy and uploads them again.
* ``make_refill``       — the masked state reset: refilled slots go back to
                          their t=0 state (WAITING/VOID, full remaining
                          work, no VM, NaN stamps) without touching any
                          other slot, then ``done`` is recomputed against
                          the NEW consts.

The driver on top lives in ``repro_torch.api.stream``
(``Experiment.run_stream``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .ctrlplane import CtrlPlaneConfig
from .engine import EngineConsts, _finished
from .failures import DegradationSchedule, FailureSchedule
from .mapreduce import (GBIT, KIND_MAP, KIND_REDUCE, PHASE_IN, PHASE_OUT,
                        PHASE_SHUFFLE, VOID, WAITING, ClusterSpec, JobSpec,
                        SimSetup)
from .routing import RouteTable, build_route_table

# The EngineConsts leaves a slot refill rewrites: everything derived from
# the job list.  Topology / cluster / failure / ctrl leaves are NOT here:
# they stay lane-shared and a refill never touches them.
STREAM_FIELDS = (
    "job_release", "job_total_mi", "job_priority", "job_n_out", "job_valid",
    "job_n_tasks",
    "task_job", "task_kind", "task_mi", "task_need", "task_valid",
    "task_rank_in_job",
    "pkt_job", "pkt_phase", "pkt_bits", "pkt_gate_task", "pkt_feeds_task",
    "pkt_src_task", "pkt_dst_task", "pkt_valid",
)


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Uniform slot geometry: the largest job shape a slot can hold.

    Slot ``s`` owns tasks ``[s*tasks_per_slot, (s+1)*tasks_per_slot)`` and
    packets ``[s*pkts_per_slot, (s+1)*pkts_per_slot)``; a smaller job pads
    the tail of its blocks with VOID entries, exactly like a packed sweep
    pads scenarios (DESIGN.md §5) — pad slots are inert by construction."""

    slots: int
    n_map_max: int
    n_reduce_max: int
    split: int = 1

    @property
    def tasks_per_slot(self) -> int:
        return self.n_map_max + self.n_reduce_max

    @property
    def pkts_per_slot(self) -> int:
        nm, nr = self.n_map_max, self.n_reduce_max
        return self.split * (nm + nm * nr + nr)

    def check(self, job: JobSpec) -> None:
        if job.n_map > self.n_map_max or job.n_reduce > self.n_reduce_max:
            raise ValueError(
                f"job ({job.n_map} mappers, {job.n_reduce} reducers) "
                f"exceeds the ring slot geometry "
                f"({self.n_map_max}, {self.n_reduce_max})")

    @classmethod
    def for_jobs(cls, jobs: Sequence[JobSpec], slots: int,
                 split: int = 1) -> "RingSpec":
        """Tight geometry over a job sample (e.g. the materialized trace)."""
        if not jobs:
            raise ValueError("RingSpec.for_jobs needs at least one job")
        return cls(slots=slots,
                   n_map_max=max(j.n_map for j in jobs),
                   n_reduce_max=max(j.n_reduce for j in jobs),
                   split=split)


def slot_arrays(spec: RingSpec, slot: int,
                job: Optional[JobSpec] = None) -> Dict[str, np.ndarray]:
    """Lower one job into slot ``slot``'s blocks of the streamed tensors.

    Mirrors ``build_setup``'s per-job loop exactly — mappers then reducers,
    then the T1 / T2 / T3 packet groups in the same nesting order — with
    the slot's pad tail after the valid prefix.  ``job=None`` lowers an
    empty (all-pad, ``job_valid=False``) slot.  Task references inside the
    packet arrays are GLOBAL indices (offset by the slot's task base);
    ``task_job``/``pkt_job`` carry the slot index as the job id."""
    T, P, split = spec.tasks_per_slot, spec.pkts_per_slot, spec.split
    out = {
        "job_release": np.float32(0.0),
        "job_total_mi": np.float32(0.0),
        "job_priority": np.float32(0.0),
        "job_n_out": np.int32(0),
        "job_valid": np.bool_(False),
        "job_n_tasks": np.int32(0),
        "task_job": np.full(T, -1, np.int32),
        "task_kind": np.zeros(T, np.int8),
        "task_mi": np.zeros(T, np.float32),
        "task_need": np.zeros(T, np.int32),
        "task_valid": np.zeros(T, bool),
        # rank within the slot's (single) job = local index; the pad tail's
        # value is never read (pad tasks stay VOID and are never placed)
        "task_rank_in_job": np.arange(T, dtype=np.int32),
        "pkt_job": np.full(P, -1, np.int32),
        "pkt_phase": np.zeros(P, np.int8),
        "pkt_bits": np.zeros(P, np.float32),
        "pkt_gate_task": np.full(P, -1, np.int32),
        "pkt_feeds_task": np.full(P, -1, np.int32),
        "pkt_src_task": np.full(P, -1, np.int32),
        "pkt_dst_task": np.full(P, -1, np.int32),
        "pkt_valid": np.zeros(P, bool),
    }
    if job is None:
        return out
    spec.check(job)
    nm, nr = job.n_map, job.n_reduce
    base_t = slot * T
    mappers = list(range(base_t, base_t + nm))
    reducers = list(range(base_t + nm, base_t + nm + nr))
    out["job_release"] = np.float32(job.submit_time)
    out["job_total_mi"] = np.float32(job.total_mi)
    out["job_priority"] = np.float32(job.priority)
    out["job_n_out"] = np.int32(nr * split)
    out["job_valid"] = np.bool_(True)
    out["job_n_tasks"] = np.int32(nm + nr)
    nt = nm + nr
    out["task_job"][:nt] = slot
    out["task_kind"][:nm] = KIND_MAP
    out["task_kind"][nm:nt] = KIND_REDUCE
    out["task_mi"][:nm] = job.map_mi
    out["task_mi"][nm:nt] = job.reduce_mi
    out["task_need"][:nm] = split
    out["task_need"][nm:nt] = nm * split
    out["task_valid"][:nt] = True

    p_bits: List[float] = []
    p_phase: List[int] = []
    p_gate: List[int] = []
    p_feeds: List[int] = []
    p_src: List[int] = []
    p_dst: List[int] = []
    ms_bits = job.input_gbits * GBIT / (nm * split)
    for m in mappers:
        for _ in range(split):
            p_phase.append(PHASE_IN); p_bits.append(ms_bits)
            p_gate.append(-1); p_feeds.append(m)
            p_src.append(-1); p_dst.append(m)
    sh_bits = job.shuffle_gbits * GBIT / (nm * nr * split)
    for m in mappers:
        for r in reducers:
            for _ in range(split):
                p_phase.append(PHASE_SHUFFLE); p_bits.append(sh_bits)
                p_gate.append(m); p_feeds.append(r)
                p_src.append(m); p_dst.append(r)
    out_bits = job.output_gbits * GBIT / (nr * split)
    for r in reducers:
        for _ in range(split):
            p_phase.append(PHASE_OUT); p_bits.append(out_bits)
            p_gate.append(r); p_feeds.append(-1)
            p_src.append(r); p_dst.append(-1)
    npk = len(p_bits)
    out["pkt_job"][:npk] = slot
    out["pkt_phase"][:npk] = p_phase
    out["pkt_bits"][:npk] = p_bits
    out["pkt_gate_task"][:npk] = p_gate
    out["pkt_feeds_task"][:npk] = p_feeds
    out["pkt_src_task"][:npk] = p_src
    out["pkt_dst_task"][:npk] = p_dst
    out["pkt_valid"][:npk] = True
    return out


def ring_setup(jobs: Sequence[JobSpec], cluster: ClusterSpec, spec: RingSpec,
               route_table: Optional[RouteTable] = None, k_max: int = 16,
               failures: Optional[FailureSchedule] = None,
               ctrl: Optional[CtrlPlaneConfig] = None,
               degradation: Optional[DegradationSchedule] = None,
               spec_slots: int = 0, device=None) -> SimSetup:
    """A full ring ``SimSetup``: the first ``len(jobs)`` slots loaded, the
    rest empty.  This is an ordinary setup — ``make_consts`` /
    ``Experiment.run`` accept it unchanged, which is exactly the finite-
    trace identity anchor (DESIGN.md §11).  ``device`` (``None`` = CUDA)
    runs the route table's hop-distance step when no table is given."""
    if len(jobs) > spec.slots:
        raise ValueError(f"{len(jobs)} jobs exceed {spec.slots} ring slots")
    rt = route_table or build_route_table(cluster.topo, k_max=k_max,
                                          device=device)
    blocks = [slot_arrays(spec, s, jobs[s] if s < len(jobs) else None)
              for s in range(spec.slots)]

    def cat(key):
        vals = [b[key] for b in blocks]
        return (np.stack(vals) if vals[0].ndim == 0
                else np.concatenate(vals))

    return SimSetup(
        cluster=cluster,
        route_table=rt,
        failures=failures,
        ctrl=ctrl,
        degradation=degradation,
        spec_slots=int(spec_slots),
        jobs=tuple(jobs),
        job_release=cat("job_release"),
        job_total_mi=cat("job_total_mi"),
        job_priority=cat("job_priority"),
        job_n_out=cat("job_n_out"),
        task_job=cat("task_job"),
        task_kind=cat("task_kind"),
        task_mi=cat("task_mi"),
        task_need=cat("task_need"),
        task_valid=cat("task_valid"),
        pkt_job=cat("pkt_job"),
        pkt_phase=cat("pkt_phase"),
        pkt_bits=cat("pkt_bits"),
        pkt_gate_task=cat("pkt_gate_task"),
        pkt_feeds_task=cat("pkt_feeds_task"),
        pkt_src_task=cat("pkt_src_task"),
        pkt_dst_task=cat("pkt_dst_task"),
        pkt_valid=cat("pkt_valid"),
    )


def host_stream_arrays(consts: EngineConsts,
                       width: int) -> Dict[str, np.ndarray]:
    """Mutable host copies of the streamed leaves with a leading ``[width]``
    lane axis, seeded from one (unbatched) consts, so the zero-refill
    stream uploads EXACTLY what ``make_consts`` produced."""
    # torchcheck: disable=item-call: host copies of the streamed consts, at
    # setup
    return {f: np.repeat(getattr(consts, f).cpu().numpy()[None], width,
                         axis=0)
            for f in STREAM_FIELDS}


def load_slot(host: Dict[str, np.ndarray], spec: RingSpec, lane: int,
              slot: int, job: Optional[JobSpec]) -> None:
    """Rewrite one (lane, slot)'s blocks of the host streamed arrays."""
    blk = slot_arrays(spec, slot, job)
    T, P = spec.tasks_per_slot, spec.pkts_per_slot
    for f in STREAM_FIELDS:
        v = blk[f]
        if v.ndim == 0:
            host[f][lane, slot] = v
        elif f.startswith("task_"):
            host[f][lane, slot * T:(slot + 1) * T] = v
        else:
            host[f][lane, slot * P:(slot + 1) * P] = v


def make_refill(meta):
    """The streaming refill ``refill(consts, carry, job_m, task_m, pkt_m,
    lane_m) -> carry`` over the engine's carry ``(s, cache, nc, done)``.

    ``consts`` holds the ALREADY-REWRITTEN streamed leaves ``[W, ...]``;
    the masks ``[W, n]`` select the refilled slots' entries per lane.
    Refilled entries go back to their t=0 state (``init_state_from_consts``
    semantics) while every other entry passes through untouched: the
    endpoint cache, the carried channel counts and the flow tables (whose
    stale rules for retired flows age out via LRU) among them.  ``steps``
    resets on refilled lanes (``lane_m``: the step budget bounds events
    BETWEEN refills, which a full ring's ``default_max_steps`` covers), the
    clock and ``place_counter`` run on, and ``done`` is recomputed against
    the new consts.  The endpoint cache needs no refresh: a refilled job's
    packets cannot activate before the job is admitted AND placed, and
    placement refreshes the cache inside ``_step`` that same event.  With
    clone slots, a clone still bound to a recycled job slot is cancelled
    (a lane can finish with live clones and never step again before the
    refill) and gives its VM's load back, and the refilled tasks' one-clone
    latch is re-armed."""
    nan, inf = float("nan"), float("inf")

    def where(m, v, a):
        return torch.where(m, v, a).to(a.dtype)

    def refill(consts: EngineConsts, carry, job_m, task_m, pkt_m, lane_m):
        s, cache, nc, _ = carry
        c = consts
        extra = {}
        if meta.spec_slots > 0:
            n_s = s.spec_of.shape[1]
            slot_job = torch.arange(n_s, device=job_m.device
                                    ) // meta.spec_slots
            clone_m = job_m[:, slot_job]
            live = clone_m & (s.spec_of >= 0)
            # integer scatter-add: exact in any order
            give_back = torch.zeros_like(s.vm_load).scatter_add(
                1, s.spec_vm.clamp(min=0).long(), live.to(s.vm_load.dtype))
            extra = dict(
                spec_of=where(clone_m, -1, s.spec_of),
                spec_vm=where(clone_m, -1, s.spec_vm),
                spec_rem=where(clone_m, 0.0, s.spec_rem),
                spec_start=where(clone_m, 0.0, s.spec_start),
                task_cloned=where(task_m, False, s.task_cloned),
                vm_load=s.vm_load - give_back)
        s = s._replace(
            **extra,
            steps=where(lane_m, 0, s.steps),
            job_admitted=where(job_m, False, s.job_admitted),
            job_admit_t=where(job_m, nan, s.job_admit_t),
            job_out_done=where(job_m, 0, s.job_out_done),
            job_done_t=where(job_m, nan, s.job_done_t),
            job_downtime=where(job_m, 0.0, s.job_downtime),
            task_state=where(task_m, torch.where(c.task_valid, WAITING, VOID),
                             s.task_state),
            task_rem=where(task_m, c.task_mi, s.task_rem),
            task_got=where(task_m, 0, s.task_got),
            task_vm=where(task_m, -1, s.task_vm),
            task_start=where(task_m, nan, s.task_start),
            task_finish=where(task_m, nan, s.task_finish),
            task_restarts=where(task_m, 0, s.task_restarts),
            pkt_state=where(pkt_m, torch.where(c.pkt_valid, WAITING, VOID),
                            s.pkt_state),
            pkt_rem=where(pkt_m, c.pkt_bits, s.pkt_rem),
            pkt_pair=where(pkt_m, -1, s.pkt_pair),
            pkt_cand=where(pkt_m, -1, s.pkt_cand),
            pkt_start=where(pkt_m, nan, s.pkt_start),
            pkt_finish=where(pkt_m, nan, s.pkt_finish),
            pkt_reroutes=where(pkt_m, 0, s.pkt_reroutes),
            pkt_ready_t=where(pkt_m, inf, s.pkt_ready_t),
            pkt_install_wait=where(pkt_m, 0.0, s.pkt_install_wait))
        return s, cache, nc, _finished(consts, meta, s)

    return refill
