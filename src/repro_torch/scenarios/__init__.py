"""Scenario library: port of ``src/repro/scenarios`` (workloads and the
plain registry entries)."""
from .registry import Scenario, get_scenario, list_scenarios, make_cluster
from .workloads import (JobTemplate, bursty_workload, uniform_workload,
                        zipf_workload)

__all__ = ["Scenario", "get_scenario", "list_scenarios", "make_cluster",
           "JobTemplate", "bursty_workload", "uniform_workload",
           "zipf_workload"]
