"""Scenario library: port of ``src/repro/scenarios`` (workloads, the
registry, the failure-trace generators and the packed multi-topology
sweep).  The arrival processes come with ROADMAP queue 1 item 9."""
from .failures import failure_injector, random_failures
from .registry import (Scenario, get_scenario, list_scenarios, make_cluster,
                       register)
from .sweep import SweepResult, pack_setups, policy_arrays, sweep_grid
from .workloads import (JobTemplate, bursty_workload, uniform_workload,
                        zipf_workload)

__all__ = ["Scenario", "get_scenario", "list_scenarios", "make_cluster",
           "register",
           "SweepResult", "pack_setups", "policy_arrays", "sweep_grid",
           "JobTemplate", "bursty_workload", "uniform_workload",
           "zipf_workload",
           "failure_injector", "random_failures"]
