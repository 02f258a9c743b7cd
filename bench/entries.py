"""The ways a user drives the simulator, one experiment each; the traffic
file's ``entry`` names the one a cell runs.  Each experiment is the
seeded build, the run and the report read to the host; spans go to the
``Recorder``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from . import traffic as gen


@dataclasses.dataclass
class Deployment:
    """A configuration and its traffic set up on the program, once."""

    program: Any
    config: dict
    traffic: dict
    topology: Any
    cluster: Any
    route_table: Any
    lanes: List[dict]


def deploy(program, config: dict, traffic: dict, topo=None,
           route_table=None) -> Deployment:
    """The program's fabric and route table (unless given), its cluster
    and the traffic's lanes."""
    topo = program.topology(config) if topo is None else topo
    rt = route_table if route_table is not None else \
        program.route_table(config, topo)
    return Deployment(program=program, config=config, traffic=traffic,
                      topology=topo, cluster=program.cluster(config, topo),
                      route_table=rt, lanes=gen.lanes(traffic))


@dataclasses.dataclass
class Outcome:
    """What one experiment did: simulations run to their end, the loop's
    trip count, and its results."""

    k: int
    sims: int
    trip: int
    result: Any
    report: Optional[tuple] = None


def sweep(dep: Deployment, seed: int, k: int, rec) -> Outcome:
    """Every lane of the sweep in one ``Experiment.run`` on experiment
    ``k``'s job order, then its Eqs. 6-9 and energy reports."""
    with rec.span("build"):
        setup = dep.program.setup(dep.config,
                                  gen.job_order(dep.config, seed, k),
                                  dep.cluster, dep.route_table)
        exp = dep.program.experiment(setup, dep.lanes)
        exp.build()
        exp.policy_arrays()
    with rec.span("run") as a:
        res = exp.run()
        a["trip"] = int(res.states.steps.max())
    with rec.span("report"):
        report = res.job_report(), res.energy_report()
    return Outcome(k=k, sims=len(res), trip=a["trip"], result=res,
                   report=report)


ENTRIES: Dict[str, Callable] = {"run": sweep}
