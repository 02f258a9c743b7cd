"""MapReduce application model (paper §3.1.3, Fig. 7, Eqs. 1-2).

A job = nm mappers + nr reducers with the strict 5-phase pipeline:
  T1 SAN->mapper transfer   (one packet per mapper,   ms = jl/nm       Eq. 1)
  P1 map execution          (gated on its T1 packet)
  T2 mapper->reducer shuffle (one packet per (m,r),   rs = ms*f        Eq. 2)
  P2 reduce execution       (gated on ALL its T2 packets)
  T3 reducer->SAN write-back (one packet per reducer; job done when all land)

Host-side setup converts a job table into padded, fixed-shape packet/task
tensors with integer dependency gates — the whole DAG becomes index
arithmetic the event engine evaluates vectorially.

Port of ``src/repro/core/mapreduce.py`` (numpy copy); ``build_setup`` takes
``device=`` and hands it to the route-table build, whose hop-distance step
runs on that device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .ctrlplane import CtrlPlaneConfig
from .energy import EnergyParams
from .failures import DegradationSchedule, FailureSchedule
from .routing import RouteTable, build_route_table
from .topology import Topology

GBIT = 1e9

# packet / task states.  INSTALLING (packets only, DESIGN.md §10): routed,
# waiting for its flow rules to finish installing at the controller.
WAITING, ACTIVE, DONE, VOID, INSTALLING = 0, 1, 2, 3, 4
KIND_MAP, KIND_REDUCE = 0, 1
PHASE_IN, PHASE_SHUFFLE, PHASE_OUT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One MapReduce job (paper Table 3 row)."""

    submit_time: float
    n_map: int
    n_reduce: int
    map_mi: float          # MI per mapper
    reduce_mi: float       # MI per reducer
    input_gbits: float     # total SAN->mappers        ("Storage" column)
    shuffle_gbits: float   # total mappers->reducers   ("Mappers" column)
    output_gbits: float    # total reducers->SAN       ("Reducers" column)
    priority: float = 0.0

    @property
    def total_mi(self) -> float:
        return self.n_map * self.map_mi + self.n_reduce * self.reduce_mi


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Hosts + VMs + SAN (paper Table 2)."""

    topo: Topology
    vm_host: np.ndarray          # int32 [n_vms]
    vm_total_mips: np.ndarray    # f32  [n_vms]
    vm_core_mips: np.ndarray     # f32  [n_vms]
    host_total_mips: np.ndarray  # f32  [n_hosts] (for utilization/energy)
    storage_node: int
    intra_bw: float = 1e12       # same-host VM-to-VM "memory bus"
    energy: EnergyParams = EnergyParams()


@dataclasses.dataclass(frozen=True)
class SimSetup:
    """Everything the engine needs: static numpy tensors + sizes."""

    cluster: ClusterSpec
    route_table: RouteTable
    jobs: Sequence[JobSpec]
    # job tensors [N_J]
    job_release: np.ndarray
    job_total_mi: np.ndarray
    job_priority: np.ndarray
    job_n_out: np.ndarray
    # task tensors [N_T]
    task_job: np.ndarray
    task_kind: np.ndarray
    task_mi: np.ndarray
    task_need: np.ndarray
    task_valid: np.ndarray
    # packet tensors [N_P]
    pkt_job: np.ndarray
    pkt_phase: np.ndarray
    pkt_bits: np.ndarray
    pkt_gate_task: np.ndarray   # -1 -> gated only on job admission
    pkt_feeds_task: np.ndarray  # -1 -> job output packet
    pkt_src_task: np.ndarray    # -1 -> SAN
    pkt_dst_task: np.ndarray    # -1 -> SAN
    pkt_valid: np.ndarray
    # optional deterministic outage windows (DESIGN.md §7); None = the
    # all-inf no-failure schedule
    failures: FailureSchedule | None = None
    # optional control-plane resource model (DESIGN.md §10); None = the
    # identity instant-controller config
    ctrl: CtrlPlaneConfig | None = None
    # optional gray-failure rate-multiplier windows (DESIGN.md §13);
    # None = the identity factor-1.0 schedule
    degradation: DegradationSchedule | None = None
    # speculative-execution clone slots PER JOB (DESIGN.md §13); 0 =
    # speculation structurally off (the clone tensors are zero-length)
    spec_slots: int = 0

    @property
    def n_jobs(self) -> int:
        return int(self.job_release.shape[0])

    @property
    def n_tasks(self) -> int:
        return int(self.task_job.shape[0])

    @property
    def n_packets(self) -> int:
        return int(self.pkt_job.shape[0])


def build_setup(jobs: Sequence[JobSpec], cluster: ClusterSpec,
                route_table: RouteTable | None = None,
                k_max: int = 16, split: int = 1,
                failures: FailureSchedule | None = None,
                ctrl: CtrlPlaneConfig | None = None,
                degradation: DegradationSchedule | None = None,
                spec_slots: int = 0, device=None) -> SimSetup:
    """``split`` = network packets per logical transfer (paper: workloads
    specify "the size of network packets" in the CSV; a data block is sent as
    multiple packet objects, EACH routed by the controller — "two packets
    from the same VM can have two different routes to the same destination
    VM" §5.2).  The SDN policy stripes a transfer across equal-hop routes;
    the legacy policy pins all of a flow's packets to one random route."""
    rt = route_table or build_route_table(cluster.topo, k_max=k_max,
                                          device=device)

    t_job: List[int] = []
    t_kind: List[int] = []
    t_mi: List[float] = []
    t_need: List[int] = []
    p_job: List[int] = []
    p_phase: List[int] = []
    p_bits: List[float] = []
    p_gate: List[int] = []
    p_feeds: List[int] = []
    p_src: List[int] = []
    p_dst: List[int] = []

    assert split >= 1
    for j, job in enumerate(jobs):
        nm, nr = job.n_map, job.n_reduce
        assert nm >= 1 and nr >= 1, "a MapReduce job needs >=1 mapper & reducer"
        base_t = len(t_job)
        mappers = list(range(base_t, base_t + nm))
        reducers = list(range(base_t + nm, base_t + nm + nr))
        for _ in range(nm):
            t_job.append(j); t_kind.append(KIND_MAP)
            t_mi.append(job.map_mi); t_need.append(split)
        for _ in range(nr):
            t_job.append(j); t_kind.append(KIND_REDUCE)
            t_mi.append(job.reduce_mi); t_need.append(nm * split)
        # T1: SAN -> mapper, Eq. 1: ms = jl / nm, sent as `split` packets
        ms_bits = job.input_gbits * GBIT / (nm * split)
        for m in mappers:
            for _ in range(split):
                p_job.append(j); p_phase.append(PHASE_IN); p_bits.append(ms_bits)
                p_gate.append(-1); p_feeds.append(m)
                p_src.append(-1); p_dst.append(m)
        # T2: mapper -> reducer, Eq. 2 generalized: each mapper emits
        # shuffle_total/nm, split evenly over reducers
        sh_bits = job.shuffle_gbits * GBIT / (nm * nr * split)
        for m in mappers:
            for r in reducers:
                for _ in range(split):
                    p_job.append(j); p_phase.append(PHASE_SHUFFLE)
                    p_bits.append(sh_bits)
                    p_gate.append(m); p_feeds.append(r)
                    p_src.append(m); p_dst.append(r)
        # T3: reducer -> SAN
        out_bits = job.output_gbits * GBIT / (nr * split)
        for r in reducers:
            for _ in range(split):
                p_job.append(j); p_phase.append(PHASE_OUT)
                p_bits.append(out_bits)
                p_gate.append(r); p_feeds.append(-1)
                p_src.append(r); p_dst.append(-1)

    def pad(lst, n, fill):
        return np.asarray(lst + [fill] * (n - len(lst)))

    n_t = len(t_job)
    n_p = len(p_job)
    if failures is not None:
        failures.validate(cluster.topo.n_hosts, cluster.topo.n_links)
    if ctrl is not None:
        ctrl.validate()
    if degradation is not None:
        degradation.validate(cluster.topo.n_hosts, cluster.topo.n_links)
    if spec_slots < 0:
        raise ValueError("spec_slots must be >= 0")
    return SimSetup(
        cluster=cluster,
        route_table=rt,
        failures=failures,
        ctrl=ctrl,
        degradation=degradation,
        spec_slots=int(spec_slots),
        jobs=tuple(jobs),
        job_release=np.asarray([j.submit_time for j in jobs], np.float32),
        job_total_mi=np.asarray([j.total_mi for j in jobs], np.float32),
        job_priority=np.asarray([j.priority for j in jobs], np.float32),
        job_n_out=np.asarray([j.n_reduce * split for j in jobs], np.int32),
        task_job=pad(t_job, n_t, -1).astype(np.int32),
        task_kind=pad(t_kind, n_t, 0).astype(np.int8),
        task_mi=pad(t_mi, n_t, 0.0).astype(np.float32),
        task_need=pad(t_need, n_t, 0).astype(np.int32),
        task_valid=(pad(t_job, n_t, -1) >= 0),
        pkt_job=pad(p_job, n_p, -1).astype(np.int32),
        pkt_phase=pad(p_phase, n_p, 0).astype(np.int8),
        pkt_bits=pad(p_bits, n_p, 0.0).astype(np.float32),
        pkt_gate_task=pad(p_gate, n_p, -1).astype(np.int32),
        pkt_feeds_task=pad(p_feeds, n_p, -1).astype(np.int32),
        pkt_src_task=pad(p_src, n_p, -1).astype(np.int32),
        pkt_dst_task=pad(p_dst, n_p, -1).astype(np.int32),
        pkt_valid=(pad(p_job, n_p, -1) >= 0),
    )
