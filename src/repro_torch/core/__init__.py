"""The simulator core in PyTorch: port of ``src/repro/core``."""
from .ctrlplane import CtrlPlaneConfig, no_ctrl
from .energy import EnergyParams
from .engine import (EngineConsts, SimState, init_fleet_carry, init_state,
                     make_consts, make_fleet_chunk, make_packed_simulator,
                     make_simulator, simulate, simulate_batch,
                     simulate_scenarios, tree_select)
from .failures import (DegradationSchedule, FailureSchedule, host_crash,
                       host_slowdown, link_brownout, link_cut,
                       no_degradation, no_failures)
from .mapreduce import ClusterSpec, JobSpec, SimSetup, build_setup
from .policies import (INSTALL_PROACTIVE, INSTALL_REACTIVE, JOBSEL_FCFS,
                       JOBSEL_PRIORITY, JOBSEL_SJF, MIG_CONGESTION,
                       MIG_STATIC, PLACE_LEAST_USED, PLACE_RANDOM,
                       PLACE_ROUND_ROBIN, RECOVERY_RESTART, RECOVERY_RESUME,
                       ROUTE_LEGACY, ROUTE_SDN, SPEC_OFF, SPEC_ON,
                       TRAFFIC_FAIRSHARE, TRAFFIC_WATERFILL, PolicyConfig,
                       as_policy_arrays)
from .report import energy_report, job_report, job_report_consts, summarize
from .routing import RouteTable, build_route_table
from .simmeta import SimMeta
from .topology import (GBPS, Topology, canonical_tree, fat_tree, leaf_spine,
                       paper_fat_tree, torus_2d, torus_3d)
from .usecase import paper_cluster, paper_jobs, paper_setup

__all__ = [
    "CtrlPlaneConfig", "no_ctrl", "EnergyParams", "EngineConsts", "SimState", "init_state", "make_consts",
    "make_packed_simulator", "make_simulator",
    "init_fleet_carry", "make_fleet_chunk", "tree_select",
    "simulate", "simulate_batch", "simulate_scenarios",
    "DegradationSchedule", "FailureSchedule", "host_crash", "host_slowdown",
    "link_brownout", "link_cut", "no_degradation", "no_failures",
    "ClusterSpec", "JobSpec", "SimSetup", "build_setup",
    "INSTALL_PROACTIVE", "INSTALL_REACTIVE", "MIG_CONGESTION", "MIG_STATIC",
    "SPEC_OFF", "SPEC_ON",
    "JOBSEL_FCFS", "JOBSEL_PRIORITY", "JOBSEL_SJF",
    "PLACE_LEAST_USED", "PLACE_RANDOM", "PLACE_ROUND_ROBIN",
    "RECOVERY_RESTART", "RECOVERY_RESUME",
    "ROUTE_LEGACY", "ROUTE_SDN", "TRAFFIC_FAIRSHARE", "TRAFFIC_WATERFILL",
    "PolicyConfig", "as_policy_arrays",
    "energy_report", "job_report", "job_report_consts", "summarize",
    "RouteTable", "build_route_table", "SimMeta",
    "GBPS", "Topology", "canonical_tree", "fat_tree", "leaf_spine",
    "paper_fat_tree", "torus_2d", "torus_3d",
    "paper_cluster", "paper_jobs", "paper_setup",
]
