"""Scenario library: port of ``src/repro/scenarios`` (workloads, the
registry, the failure and gray-failure trace generators and the packed
multi-topology sweep) and the open arrival processes that feed the
streaming ring."""
from .arrivals import (Arrival, ArrivalProcess, DiurnalArrivals,
                       PoissonArrivals, ServiceClass, TraceArrivals,
                       as_workload)
from .failures import (degradation_injector, failure_injector,
                       random_degradation, random_failures)
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
           "degradation_injector", "failure_injector",
           "random_degradation", "random_failures",
           "Arrival", "ArrivalProcess", "PoissonArrivals", "DiurnalArrivals",
           "TraceArrivals", "ServiceClass", "as_workload"]
