"""The paper's §5 experiment: Tables 2-3, Fig. 9 topology, 15 jobs.

Port of ``src/repro/core/usecase.py`` (numpy copy); ``paper_setup`` takes
``device=`` for the route-table build.

Host & SAN: 8 CPUs, 30 GB, 10000 MIPS.   VM: 4 CPUs, 8 GB, 1250 MIPS/core.
Links: SAN<->core1 4 Gbps, all switch/host links 1 Gbps.
Jobs: 5 small / 5 medium / 5 big (Table 3), submitted in random order with a
1 s interval (§5.3).  16 VMs, one per host, one application master.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .energy import EnergyParams
from .mapreduce import ClusterSpec, JobSpec, SimSetup, build_setup
from .topology import paper_fat_tree

# Table 3 rows: (map MI, reduce MI, storage Gb, mappers Gb, reducers Gb, nm, nr)
TABLE3 = {
    "small": (100_000.0, 75_000.0, 200.0, 150.0, 100.0, 2, 1),
    "medium": (200_000.0, 175_000.0, 400.0, 350.0, 300.0, 4, 2),
    "big": (300_000.0, 275_000.0, 600.0, 550.0, 500.0, 6, 3),
}

VM_CORES, VM_CORE_MIPS = 4, 1250.0
HOST_CORES, HOST_MIPS = 8, 10_000.0


def paper_jobs(seed: int = 0, interval_s: float = 1.0,
               n_each: int = 5) -> List[JobSpec]:
    """15 jobs in random order, 1 s apart (paper §5.3)."""
    kinds = ["small"] * n_each + ["medium"] * n_each + ["big"] * n_each
    rng = np.random.RandomState(seed)
    rng.shuffle(kinds)
    jobs = []
    for i, kind in enumerate(kinds):
        m_mi, r_mi, st, mp, rd, nm, nr = TABLE3[kind]
        jobs.append(JobSpec(submit_time=i * interval_s, n_map=nm, n_reduce=nr,
                            map_mi=m_mi, reduce_mi=r_mi, input_gbits=st,
                            shuffle_gbits=mp, output_gbits=rd))
    return jobs


def paper_cluster(n_vms: int = 16) -> ClusterSpec:
    topo = paper_fat_tree()
    # one VM per host, round-robin (paper: "simple VM allocation policy")
    vm_host = np.arange(n_vms, dtype=np.int32) % topo.n_hosts
    return ClusterSpec(
        topo=topo,
        vm_host=vm_host,
        vm_total_mips=np.full(n_vms, VM_CORES * VM_CORE_MIPS, np.float32),
        vm_core_mips=np.full(n_vms, VM_CORE_MIPS, np.float32),
        host_total_mips=np.full(topo.n_hosts, HOST_CORES * HOST_MIPS,
                                np.float32),
        storage_node=topo.storage(0),
        energy=EnergyParams(),
    )


def paper_setup(seed: int = 0, jobs: Sequence[JobSpec] | None = None,
                n_vms: int = 16, split: int = 2, device=None) -> SimSetup:
    """split=2: each logical transfer is sent as 2 network packets (the CSV
    'size of network packets' attribute; calibrated in EXPERIMENTS.md).
    ``device`` runs the route table's hop-distance step (``None`` = CUDA)."""
    return build_setup(list(jobs) if jobs is not None else paper_jobs(seed),
                       paper_cluster(n_vms), split=split, device=device)
