"""Seeded failure-trace generators (DESIGN.md §7).

Port of ``src/repro/scenarios/failures.py`` (``random_failures`` and
``failure_injector``, numpy copies): deterministic functions from
``(topology, rate parameters, seed)`` to a ``core.failures.
FailureSchedule``, drawn with ``np.random.default_rng(seed)`` in the
reference's order, so one seed gives one schedule in both packages.  The
gray-failure generators (``random_degradation``, ``degradation_injector``)
come with ROADMAP queue 1 item 7.

``random_failures`` draws at most ONE outage per device per run:
fail ~ Exp(1/rate) kept iff it lands inside the horizon, repair duration ~
Exp(mttr) (or permanent when ``mttr`` is None).  Link outages are drawn
per undirected CABLE (``Topology.cable_pairs``) and applied to both
directed slots, so a cut severs the full-duplex pair.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..core.failures import FailureSchedule, no_failures
from ..core.mapreduce import SimSetup
from ..core.topology import Topology


def random_failures(topo: Topology, *, host_rate: float = 0.0,
                    link_rate: float = 0.0, mttr: float | None = None,
                    horizon: float = np.inf,
                    seed: int = 0) -> FailureSchedule:
    """Exponential arrival / exponential repair outage trace.

    host_rate / link_rate : failures per second per device (0 = never)
    mttr                  : mean seconds to repair; None = permanent
    horizon               : failures drawn past this instant are dropped
                            (use roughly the expected makespan)
    """
    rng = np.random.default_rng(seed)
    sched = no_failures(topo.n_hosts, topo.n_links)

    def draw(fail_t, recover_t, idx, rate):
        if rate <= 0.0:
            return
        t = rng.exponential(1.0 / rate)
        if not (t < horizon):
            return
        fail_t[idx] = t
        recover_t[idx] = t + rng.exponential(mttr) if mttr is not None \
            else np.inf

    for h in range(topo.n_hosts):
        draw(sched.host_fail_t, sched.host_recover_t, h, host_rate)
    # one draw per undirected cable, applied to both directed slots
    for a, b in topo.cable_pairs():
        draw(sched.link_fail_t, sched.link_recover_t, a, link_rate)
        sched.link_fail_t[b] = sched.link_fail_t[a]
        sched.link_recover_t[b] = sched.link_recover_t[a]
    return sched.validate(topo.n_hosts, topo.n_links)


def failure_injector(**kw) -> Callable[[SimSetup], FailureSchedule]:
    """A ``(SimSetup) -> FailureSchedule`` closure over ``random_failures``
    parameters — the shape ``Experiment(failures=...)`` accepts, so one
    rate spec applies to scenarios of any topology."""

    def inject(setup: SimSetup) -> FailureSchedule:
        return random_failures(setup.cluster.topo, **kw)

    return inject
