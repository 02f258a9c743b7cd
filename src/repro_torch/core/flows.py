"""Generic flow-level frontend to the DES (beyond the MapReduce builder).

``flows_setup`` turns an arbitrary set of node-to-node transfers — with
optional round barriers — into a ``SimSetup`` the event engine runs.  This
is how closed-form test scenarios are written (the reference's roofline
advisor also replays collective schedules through it).

Rounds: packets of round r+1 activate only after EVERY round-r packet has
landed (modeled with a zero-MI barrier task per round, fed by all round-r
packets).  Endpoints are direct node ids (engine NODE_OFFSET encoding).

Port of ``src/repro/core/flows.py`` (numpy copy); ``flows_setup`` takes
``device=`` for the route-table build.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .energy import EnergyParams
from .engine import NODE_OFFSET
from .mapreduce import ClusterSpec, JobSpec, SimSetup
from .routing import RouteTable, build_route_table
from .topology import Topology

GBIT = 1e9


@dataclasses.dataclass(frozen=True)
class Flow:
    src: int            # node id
    dst: int            # node id
    gbits: float
    round: int = 0


def flows_cluster(topo: Topology, mips: float = 1e9) -> ClusterSpec:
    """One VM per host; compute is irrelevant (flows carry 0 MI)."""
    n = topo.n_hosts
    return ClusterSpec(
        topo=topo,
        vm_host=np.arange(n, dtype=np.int32),
        vm_total_mips=np.full(n, mips, np.float32),
        vm_core_mips=np.full(n, mips, np.float32),
        host_total_mips=np.full(n, mips, np.float32),
        storage_node=topo.n_nodes - 1 if topo.n_storage else 0,
        energy=EnergyParams(),
    )


def flows_setup(topo: Topology, flows: Sequence[Flow], *,
                k_max: int = 8,
                route_table: RouteTable | None = None,
                device=None) -> SimSetup:
    cluster = flows_cluster(topo)
    rt = route_table or build_route_table(topo, k_max=k_max, device=device)
    rounds = sorted({f.round for f in flows})
    r_index = {r: i for i, r in enumerate(rounds)}
    n_rounds = len(rounds)
    per_round = [sum(1 for f in flows if f.round == r) for r in rounds]

    p_job, p_phase, p_bits = [], [], []
    p_gate, p_feeds, p_src, p_dst = [], [], [], []
    for f in flows:
        ri = r_index[f.round]
        last = ri == n_rounds - 1
        p_job.append(0)
        p_phase.append(min(ri, 2))
        p_bits.append(f.gbits * GBIT)
        p_gate.append(ri - 1 if ri > 0 else -1)   # gated on prior barrier
        p_feeds.append(-1 if last else ri)        # last round = job output
        p_src.append(NODE_OFFSET + f.src)
        p_dst.append(NODE_OFFSET + f.dst)
    n_t, n_p = n_rounds, len(p_job)

    return SimSetup(
        cluster=cluster,
        route_table=rt,
        jobs=(JobSpec(submit_time=0.0, n_map=1, n_reduce=1, map_mi=0,
                      reduce_mi=0, input_gbits=0, shuffle_gbits=0,
                      output_gbits=0),),
        job_release=np.zeros(1, np.float32),
        job_total_mi=np.zeros(1, np.float32),
        job_priority=np.zeros(1, np.float32),
        job_n_out=np.asarray([per_round[-1]], np.int32),
        task_job=np.zeros(n_t, np.int32),
        task_kind=np.zeros(n_t, np.int8),
        task_mi=np.zeros(n_t, np.float32),
        task_need=np.asarray(per_round, np.int32),
        task_valid=np.ones(n_t, bool),
        pkt_job=np.asarray(p_job, np.int32),
        pkt_phase=np.asarray(p_phase, np.int8),
        pkt_bits=np.asarray(p_bits, np.float32),
        pkt_gate_task=np.asarray(p_gate, np.int32),
        pkt_feeds_task=np.asarray(p_feeds, np.int32),
        pkt_src_task=np.asarray(p_src, np.int32),
        pkt_dst_task=np.asarray(p_dst, np.int32),
        pkt_valid=np.ones(n_p, bool),
    )
