"""Scenario registry: named (topology × cluster × workload) bundles
(DESIGN.md §5).

Port of ``src/repro/scenarios/registry.py``: ``Scenario``, ``make_cluster``,
``register``, the five plain entries (``paper-fabric``, ``fat-tree``,
``leaf-spine``, ``canonical-tree``, ``leaf-spine-xl``), the two failure
entries (``paper-fabric-failures``, ``leaf-spine-failures``), the two
control-plane entries (``paper-fabric-ctrl``, ``leaf-spine-ctrl``) and the
two chaos entries (``paper-fabric-chaos``, ``leaf-spine-chaos``) and the
streaming entry (``leaf-spine-stream``, with its ``stream_arrivals``
process), each building the same ``SimSetup`` as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.ctrlplane import CtrlPlaneConfig
from ..core.energy import EnergyParams
from ..core.failures import DegradationSchedule, FailureSchedule
from ..core.mapreduce import ClusterSpec, JobSpec, SimSetup, build_setup
from ..core.topology import (Topology, canonical_tree, fat_tree, leaf_spine,
                             paper_fat_tree)
from ..core.usecase import (HOST_CORES, HOST_MIPS, VM_CORES, VM_CORE_MIPS,
                            paper_jobs)
from .failures import random_degradation, random_failures
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
    # optional seeded outage trace (DESIGN.md §7), built against the
    # realized topology
    failures: Optional[Callable[[Topology], FailureSchedule]] = None
    # optional control-plane resource model (DESIGN.md §10); None = the
    # identity instant controller
    ctrl: Optional[CtrlPlaneConfig] = None
    # optional gray-failure trace (DESIGN.md §13), built against the
    # realized topology
    degradation: Optional[Callable[[Topology], DegradationSchedule]] = None
    # speculative-execution clone slots per job (DESIGN.md §13)
    spec_slots: int = 0

    def build(self, device=None) -> SimSetup:
        """Lower to a ``SimSetup``; ``device`` (``None`` = CUDA) runs the
        route table's hop-distance step."""
        topo = self.topology()
        return build_setup(list(self.workload()), make_cluster(
            topo, vms_per_host=self.vms_per_host),
            k_max=self.k_max, split=self.split,
            failures=self.failures(topo) if self.failures else None,
            ctrl=self.ctrl,
            degradation=(self.degradation(topo)
                         if self.degradation else None),
            spec_slots=self.spec_slots, device=device)


_REGISTRY: Dict[str, Callable[..., Scenario]] = {}


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


@register("paper-fabric-failures")
def _paper_fabric_failures(seed: int = 0, n_each: int = 1, split: int = 2,
                           k_max: int = 16, host_rate: float = 2e-4,
                           link_rate: float = 2e-4, mttr: float = 120.0,
                           horizon: float = 1500.0) -> Scenario:
    """The paper fabric under a seeded exponential outage trace
    (DESIGN.md §7): SDN's reroute around the failure against legacy's
    static hash."""
    return Scenario(
        name="paper-fabric-failures",
        topology=paper_fat_tree,
        workload=lambda: paper_jobs(seed=seed, n_each=n_each),
        description="paper §5 fabric + seeded host/link outages",
        split=split,
        k_max=k_max,
        failures=lambda topo: random_failures(
            topo, host_rate=host_rate, link_rate=link_rate, mttr=mttr,
            horizon=horizon, seed=seed),
    )


@register("leaf-spine-failures")
def _leaf_spine_failures(n_spine: int = 4, n_leaf: int = 4,
                         hosts_per_leaf: int = 4, seed: int = 0,
                         n_jobs: int = 6, link_rate: float = 5e-4,
                         mttr: float = 60.0,
                         horizon: float = 2000.0) -> Scenario:
    """Leaf-spine Clos with link-only outages: with ``n_spine`` equal-hop
    routes per inter-leaf pair, every cut is SDN-routable-around."""
    return Scenario(
        name=f"leaf-spine-failures-{n_spine}x{n_leaf}",
        topology=lambda: leaf_spine(n_spine, n_leaf, hosts_per_leaf),
        workload=lambda: zipf_workload(n_jobs=n_jobs, seed=seed),
        description="leaf-spine Clos + seeded link cuts",
        failures=lambda topo: random_failures(
            topo, link_rate=link_rate, mttr=mttr, horizon=horizon,
            seed=seed),
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


@register("paper-fabric-ctrl")
def _paper_fabric_ctrl(seed: int = 0, n_each: int = 1, split: int = 2,
                       k_max: int = 16, install_latency: float = 0.05,
                       ctrl_rate: float = 500.0,
                       table_slots: int = 8) -> Scenario:
    """The paper fabric with the control plane as a real resource
    (DESIGN.md §10): finite rule-install latency, a rate-limited
    controller and LRU-bounded per-switch flow tables — where legacy
    routing, which needs no flow-mod round trip, can beat SDN."""
    return Scenario(
        name="paper-fabric-ctrl",
        topology=paper_fat_tree,
        workload=lambda: paper_jobs(seed=seed, n_each=n_each),
        description="paper §5 fabric + rate-limited controller with "
                    "flow-rule install latency",
        split=split,
        k_max=k_max,
        ctrl=CtrlPlaneConfig(install_latency=install_latency,
                             ctrl_rate=ctrl_rate, table_slots=table_slots),
    )


@register("leaf-spine-ctrl")
def _leaf_spine_ctrl(n_spine: int = 4, n_leaf: int = 4,
                     hosts_per_leaf: int = 4, seed: int = 0, n_jobs: int = 6,
                     install_latency: float = 0.02, ctrl_rate: float = 1000.0,
                     table_slots: int = 8, mig_threshold: float = 12.0,
                     mig_cost: float = 0.5, mig_cooldown: float = 5.0
                     ) -> Scenario:
    """Leaf-spine Clos under a finite controller with migrate-on-congestion
    armed (DESIGN.md §10): ``migration=congestion`` re-homes hot VMs;
    under ``migration=static`` the threshold is inert."""
    return Scenario(
        name=f"leaf-spine-ctrl-{n_spine}x{n_leaf}",
        topology=lambda: leaf_spine(n_spine, n_leaf, hosts_per_leaf),
        workload=lambda: zipf_workload(n_jobs=n_jobs, seed=seed),
        description="leaf-spine Clos + finite controller, migration armed",
        ctrl=CtrlPlaneConfig(install_latency=install_latency,
                             ctrl_rate=ctrl_rate, table_slots=table_slots,
                             mig_threshold=mig_threshold, mig_cost=mig_cost,
                             mig_cooldown=mig_cooldown),
    )


@register("paper-fabric-chaos")
def _paper_fabric_chaos(seed: int = 0, n_each: int = 1, split: int = 2,
                        k_max: int = 16, host_rate: float = 2e-4,
                        link_rate: float = 2e-4, mttr: float = 120.0,
                        deg_host_rate: float = 1e-3,
                        deg_link_rate: float = 1e-3,
                        mean_factor: float = 0.4, deg_mttr: float = 300.0,
                        horizon: float = 1500.0,
                        install_latency: float = 0.05,
                        ctrl_rate: float = 500.0, table_slots: int = 8,
                        ctrl_fail_t: float = 60.0,
                        ctrl_recover_t: float = 400.0,
                        failover_delay: float = 2.0,
                        backup_rate: float = 200.0,
                        backup_latency: float = 0.1,
                        spec_slots: int = 2) -> Scenario:
    """The paper fabric under the whole chaos stack (DESIGN.md §13): hard
    outages, gray slowdowns, a finite controller whose primary dies
    mid-run and fails over to a slower backup, and clone slots armed."""
    return Scenario(
        name="paper-fabric-chaos",
        topology=paper_fat_tree,
        workload=lambda: paper_jobs(seed=seed, n_each=n_each),
        description="paper §5 fabric + outages + gray degradation + "
                    "controller failover + speculation slots",
        split=split,
        k_max=k_max,
        failures=lambda topo: random_failures(
            topo, host_rate=host_rate, link_rate=link_rate, mttr=mttr,
            horizon=horizon, seed=seed),
        degradation=lambda topo: random_degradation(
            topo, host_rate=deg_host_rate, link_rate=deg_link_rate,
            mean_factor=mean_factor, mttr=deg_mttr, horizon=horizon,
            seed=seed + 1),
        ctrl=CtrlPlaneConfig(install_latency=install_latency,
                             ctrl_rate=ctrl_rate, table_slots=table_slots,
                             ctrl_fail_t=ctrl_fail_t,
                             ctrl_recover_t=ctrl_recover_t,
                             failover_delay=failover_delay,
                             backup_rate=backup_rate,
                             backup_latency=backup_latency),
        spec_slots=spec_slots,
    )


@register("leaf-spine-chaos")
def _leaf_spine_chaos(n_spine: int = 4, n_leaf: int = 4,
                      hosts_per_leaf: int = 4, seed: int = 0,
                      n_jobs: int = 6, deg_host_rate: float = 2e-3,
                      mean_factor: float = 0.3, deg_mttr: float = 400.0,
                      horizon: float = 2000.0,
                      spec_slots: int = 2) -> Scenario:
    """Leaf-spine Clos with gray host slowdowns only (no outages, no
    controller): isolates the straggler-speculation effect (DESIGN.md
    §13)."""
    return Scenario(
        name=f"leaf-spine-chaos-{n_spine}x{n_leaf}",
        topology=lambda: leaf_spine(n_spine, n_leaf, hosts_per_leaf),
        workload=lambda: zipf_workload(n_jobs=n_jobs, seed=seed),
        description="leaf-spine Clos + gray host slowdowns, speculation "
                    "slots armed",
        degradation=lambda topo: random_degradation(
            topo, host_rate=deg_host_rate, mean_factor=mean_factor,
            mttr=deg_mttr, horizon=horizon, seed=seed + 1),
        spec_slots=spec_slots,
    )


@register("leaf-spine-stream")
def _leaf_spine_stream(n_spine: int = 4, n_leaf: int = 4,
                       hosts_per_leaf: int = 4, seed: int = 0,
                       rate: float = 0.05, horizon: float = 240.0,
                       urgent_share: float = 0.3, urgent_slo: float = 120.0,
                       batch_slo: float = 600.0,
                       max_jobs: Optional[int] = None) -> Scenario:
    """Leaf-spine Clos under a two-class Poisson open-arrival mix — the
    steady-state streaming scenario (DESIGN.md §11).  Registered with a
    FINITE arrival preview (the trace below ``horizon``) so it runs under
    ``Experiment.run`` like any scenario; ``Experiment.run_stream`` with
    the same ``stream_arrivals(...)`` process streams it unbounded through
    the slot-recycling ring.  The urgent class carries a priority weight
    the ``job_selection=priority`` axis consumes, plus the tighter SLO the
    windowed metrics grade."""
    from .arrivals import as_workload
    arrivals = stream_arrivals(rate=rate, seed=seed,
                               urgent_share=urgent_share,
                               urgent_slo=urgent_slo, batch_slo=batch_slo)
    return Scenario(
        name=f"leaf-spine-stream-{n_spine}x{n_leaf}",
        topology=lambda: leaf_spine(n_spine, n_leaf, hosts_per_leaf),
        workload=lambda: as_workload(arrivals, horizon, max_jobs=max_jobs),
        description="leaf-spine Clos, two-class Poisson open arrivals "
                    "(finite preview; stream via Experiment.run_stream)",
    )


def stream_arrivals(rate: float = 0.05, seed: int = 0,
                    urgent_share: float = 0.3, urgent_slo: float = 120.0,
                    batch_slo: float = 600.0):
    """The ``leaf-spine-stream`` scenario's arrival process — importable so
    ``run_stream`` users and the finite preview share one definition."""
    from .arrivals import PoissonArrivals, ServiceClass
    classes = (
        ServiceClass("batch", weight=0.0, slo_s=batch_slo,
                     share=1.0 - urgent_share),
        ServiceClass("urgent", weight=2.0, slo_s=urgent_slo,
                     share=urgent_share,
                     template=JobTemplate(n_map=2, n_reduce=1),
                     scale_lo=0.25, scale_hi=1.0),
    )
    return PoissonArrivals(rate=rate, classes=classes, seed=seed)
