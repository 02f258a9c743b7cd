"""Seeded failure-trace generators (DESIGN.md §7).

Port of ``src/repro/scenarios/failures.py`` (``random_failures`` and
``failure_injector``, numpy copies): deterministic functions from
``(topology, rate parameters, seed)`` to a ``core.failures.
FailureSchedule``, drawn with ``np.random.default_rng(seed)`` in the
reference's order, so one seed gives one schedule in both packages; and
their gray-failure twins ``random_degradation`` and
``degradation_injector`` (DESIGN.md §13), which draw rate multipliers
instead of outages the same way.

``random_failures`` draws at most ONE outage per device per run:
fail ~ Exp(1/rate) kept iff it lands inside the horizon, repair duration ~
Exp(mttr) (or permanent when ``mttr`` is None).  Link outages are drawn
per undirected CABLE (``Topology.cable_pairs``) and applied to both
directed slots, so a cut severs the full-duplex pair.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..core.failures import (DegradationSchedule, FailureSchedule,
                             no_degradation, no_failures)
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


def random_degradation(topo: Topology, *, host_rate: float = 0.0,
                       link_rate: float = 0.0, mean_factor: float = 0.5,
                       mttr: float | None = None,
                       horizon: float = np.inf,
                       seed: int = 0) -> DegradationSchedule:
    """Seeded gray-failure trace: exponential window arrival / exponential
    restore, as ``random_failures`` draws outages, with each window's
    factor ~ U(max(mean_factor/2, 0.01), min(3*mean_factor/2, 0.95)), so a
    window always degrades and never stops a device.

    host_rate / link_rate : gray windows per second per device (0 = never)
    mean_factor           : mean of the in-window rate multiplier
    mttr                  : mean seconds until the device restores; None =
                            degraded for the rest of the run
    horizon               : windows opening past this instant are dropped
    """
    rng = np.random.default_rng(seed)
    sched = no_degradation(topo.n_hosts, topo.n_links)
    lo = max(mean_factor / 2.0, 0.01)
    hi = min(1.5 * mean_factor, 0.95)
    hi = max(hi, lo + 1e-3)

    def draw(slow_t, restore_t, factor, idx, rate):
        if rate <= 0.0:
            return
        t = rng.exponential(1.0 / rate)
        if not (t < horizon):
            return
        slow_t[idx] = t
        restore_t[idx] = t + rng.exponential(mttr) if mttr is not None \
            else np.inf
        factor[idx] = rng.uniform(lo, hi)

    for h in range(topo.n_hosts):
        draw(sched.host_slow_t, sched.host_restore_t, sched.host_factor,
             h, host_rate)
    # one draw per undirected cable, applied to both directed slots
    for a, b in topo.cable_pairs():
        draw(sched.link_slow_t, sched.link_restore_t, sched.link_factor,
             a, link_rate)
        sched.link_slow_t[b] = sched.link_slow_t[a]
        sched.link_restore_t[b] = sched.link_restore_t[a]
        sched.link_factor[b] = sched.link_factor[a]
    return sched.validate(topo.n_hosts, topo.n_links)


def degradation_injector(**kw) -> Callable[[SimSetup], DegradationSchedule]:
    """A ``(SimSetup) -> DegradationSchedule`` closure over
    ``random_degradation`` parameters — the shape
    ``Experiment(degradation=...)`` accepts."""

    def inject(setup: SimSetup) -> DegradationSchedule:
        return random_degradation(setup.cluster.topo, **kw)

    return inject
