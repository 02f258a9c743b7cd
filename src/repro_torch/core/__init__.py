"""The simulator core in PyTorch: port of ``src/repro/core`` (main path)."""
from .energy import EnergyParams
from .engine import (EngineConsts, SimState, make_consts,
                     make_packed_simulator, make_simulator)
from .mapreduce import ClusterSpec, JobSpec, SimSetup, build_setup
from .policies import (JOBSEL_FCFS, JOBSEL_PRIORITY, JOBSEL_SJF,
                       PLACE_LEAST_USED, PLACE_RANDOM, PLACE_ROUND_ROBIN,
                       ROUTE_LEGACY, ROUTE_SDN, TRAFFIC_FAIRSHARE,
                       TRAFFIC_WATERFILL, PolicyConfig, as_policy_arrays)
from .report import energy_report, job_report, summarize
from .routing import RouteTable, build_route_table
from .simmeta import SimMeta
from .topology import (GBPS, Topology, canonical_tree, fat_tree, leaf_spine,
                       paper_fat_tree, torus_2d, torus_3d)
from .usecase import paper_cluster, paper_jobs, paper_setup

__all__ = [
    "EnergyParams", "EngineConsts", "SimState", "make_consts",
    "make_packed_simulator", "make_simulator",
    "ClusterSpec", "JobSpec", "SimSetup", "build_setup",
    "JOBSEL_FCFS", "JOBSEL_PRIORITY", "JOBSEL_SJF",
    "PLACE_LEAST_USED", "PLACE_RANDOM", "PLACE_ROUND_ROBIN",
    "ROUTE_LEGACY", "ROUTE_SDN", "TRAFFIC_FAIRSHARE", "TRAFFIC_WATERFILL",
    "PolicyConfig", "as_policy_arrays",
    "energy_report", "job_report", "summarize",
    "RouteTable", "build_route_table", "SimMeta",
    "GBPS", "Topology", "canonical_tree", "fat_tree", "leaf_spine",
    "paper_fat_tree", "torus_2d", "torus_3d",
    "paper_cluster", "paper_jobs", "paper_setup",
]
