"""Scenario registry: named (topology × cluster × workload) bundles
(DESIGN.md §5).

Port of ``src/repro/scenarios/registry.py``: ``Scenario``, ``make_cluster``,
``register`` and the five plain entries (``paper-fabric``, ``fat-tree``,
``leaf-spine``, ``canonical-tree``, ``leaf-spine-xl``), each building the
same ``SimSetup`` as the reference.  The failure, control-plane, chaos and
streaming entries wait for their slices of the port; asking for one raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from ..core.energy import EnergyParams
from ..core.mapreduce import ClusterSpec, JobSpec, SimSetup, build_setup
from ..core.topology import (Topology, canonical_tree, fat_tree, leaf_spine,
                             paper_fat_tree)
from ..core.usecase import (HOST_CORES, HOST_MIPS, VM_CORES, VM_CORE_MIPS,
                            paper_jobs)
from .workloads import (JobTemplate, bursty_workload, uniform_workload,
                        zipf_workload)


def make_cluster(topo: Topology, vms_per_host: int = 1,
                 vm_cores: int = VM_CORES, vm_core_mips: float = VM_CORE_MIPS,
                 host_mips: float = HOST_CORES * HOST_MIPS,
                 energy: EnergyParams = EnergyParams()) -> ClusterSpec:
    """Paper-Table-2 cluster defaults on an arbitrary topology: VMs spread
    round-robin over hosts, SAN = the topology's storage node 0."""
    n_vms = topo.n_hosts * vms_per_host
    return ClusterSpec(
        topo=topo,
        vm_host=(np.arange(n_vms, dtype=np.int32) % topo.n_hosts),
        vm_total_mips=np.full(n_vms, vm_cores * vm_core_mips, np.float32),
        vm_core_mips=np.full(n_vms, vm_core_mips, np.float32),
        host_total_mips=np.full(topo.n_hosts, host_mips, np.float32),
        storage_node=topo.storage(0),
        energy=energy,
    )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named simulation configuration, lowered lazily by ``build()``."""

    name: str
    topology: Callable[[], Topology]
    workload: Callable[[], Sequence[JobSpec]]
    description: str = ""
    vms_per_host: int = 1
    split: int = 1
    k_max: int = 8

    def build(self, device=None) -> SimSetup:
        """Lower to a ``SimSetup``; ``device`` (``None`` = CUDA) runs the
        route table's hop-distance step."""
        return build_setup(list(self.workload()), make_cluster(
            self.topology(), vms_per_host=self.vms_per_host),
            k_max=self.k_max, split=self.split, device=device)


_REGISTRY: Dict[str, Callable[..., Scenario]] = {}

# reference registry entries that need a feature this port does not run yet
_LATER = {
    "paper-fabric-failures": "queue 1 item 5",
    "leaf-spine-failures": "queue 1 item 5",
    "paper-fabric-ctrl": "queue 1 item 6",
    "leaf-spine-ctrl": "queue 1 item 6",
    "paper-fabric-chaos": "queue 1 item 7",
    "leaf-spine-chaos": "queue 1 item 7",
    "leaf-spine-stream": "queue 1 item 9",
}


def register(name: str):
    """Decorator: ``@register("leaf-spine")`` on a ``(**kw) -> Scenario``
    factory."""

    def deco(fn: Callable[..., Scenario]):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get_scenario(name: str, **overrides) -> Scenario:
    if name in _LATER:
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet (ROADMAP {_LATER[name]})")
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# built-in scenarios
# ---------------------------------------------------------------------------


@register("paper-fabric")
def _paper_fabric(seed: int = 0, n_each: int = 1, split: int = 2,
                  k_max: int = 16) -> Scenario:
    """The paper's §5 Fig.-9 fabric with a Table-3 job mix (``n_each`` of
    each size class; the paper runs n_each=5).  split=2 and k_max=16 match
    ``usecase.paper_setup``."""
    return Scenario(
        name="paper-fabric",
        topology=paper_fat_tree,
        workload=lambda: paper_jobs(seed=seed, n_each=n_each),
        description="paper §5 three-tier fabric, Table-3 job mix",
        split=split,
        k_max=k_max,
    )


@register("fat-tree")
def _fat_tree(k: int = 4, seed: int = 0, n_jobs: int = 6) -> Scenario:
    """k-ary fat-tree with a uniform workload."""
    return Scenario(
        name=f"fat-tree-k{k}",
        topology=lambda: fat_tree(k),
        workload=lambda: uniform_workload(n_jobs=n_jobs, seed=seed),
        description=f"{k}-ary fat-tree, uniform job sizes",
    )


@register("leaf-spine")
def _leaf_spine(n_spine: int = 4, n_leaf: int = 4, hosts_per_leaf: int = 4,
                seed: int = 0, n_jobs: int = 6) -> Scenario:
    """Leaf-spine Clos with a heavy-tailed (Zipf) workload."""
    return Scenario(
        name=f"leaf-spine-{n_spine}x{n_leaf}",
        topology=lambda: leaf_spine(n_spine, n_leaf, hosts_per_leaf),
        workload=lambda: zipf_workload(n_jobs=n_jobs, seed=seed),
        description=f"{n_spine}-spine/{n_leaf}-leaf Clos, Zipf job sizes",
    )


@register("leaf-spine-xl")
def _leaf_spine_xl(n_spine: int = 8, n_leaf: int = 16, hosts_per_leaf: int = 8,
                   seed: int = 0, n_jobs: int = 128, max_scale: float = 8.0,
                   k_max: int = 8) -> Scenario:
    """Data-center-scale leaf-spine Clos (the scale Kreutz et al. argue
    controller evaluation needs): 128 hosts, 24 switches, a 128-job Zipf
    mix lowering to >=1k tasks and >=4k packets."""
    template = JobTemplate(n_map=8, n_reduce=3)
    return Scenario(
        name=f"leaf-spine-xl-{n_spine}x{n_leaf}x{hosts_per_leaf}",
        topology=lambda: leaf_spine(n_spine, n_leaf, hosts_per_leaf),
        workload=lambda: zipf_workload(n_jobs=n_jobs, seed=seed,
                                       template=template,
                                       max_scale=max_scale),
        description="128-host leaf-spine Clos, 128-job Zipf mix",
        k_max=k_max,
    )


@register("canonical-tree")
def _canonical_tree(depth: int = 3, fanout: int = 2, hosts_per_edge: int = 4,
                    seed: int = 0, n_jobs: int = 6) -> Scenario:
    """Single-rooted tree (no path diversity) with a bursty workload — the
    degenerate baseline SDN routing cannot help."""
    return Scenario(
        name=f"canonical-tree-d{depth}f{fanout}",
        topology=lambda: canonical_tree(depth, fanout, hosts_per_edge,
                                        root_bw_mult=2.0),
        workload=lambda: bursty_workload(n_jobs=n_jobs, seed=seed),
        description=f"depth-{depth} canonical tree, bursty arrivals",
    )
