"""Open-arrival processes & service classes for streaming (DESIGN.md §11).

Port of ``src/repro/scenarios/arrivals.py`` (numpy only; the same seed
draws the same trace from ``np.random.default_rng`` in the reference's
order, float for float).

The finite workload generators in ``workloads.py`` answer "what jobs exist";
an ``ArrivalProcess`` answers "when does the NEXT job arrive" — a lazy,
seed-deterministic iterator the streaming ring (``core.streaming``) refills
from, so traces of any length run in bounded memory.

Generators (all deterministic in ``seed``; same seed ⇒ identical trace):

* ``PoissonArrivals``  — homogeneous Poisson: i.i.d. exponential gaps at
                         ``rate`` jobs/s.
* ``DiurnalArrivals``  — inhomogeneous Poisson with the day-cycle rate
                         ``base_rate * (1 + amplitude*sin(2π(t-phase)/period))``
                         realized by thinning against the peak rate.
* ``TraceArrivals``    — replay explicit arrival instants (or a literal
                         ``JobSpec`` list), for trace-driven studies and
                         the finite-trace identity tests.

Service classes: each arrival samples a ``ServiceClass`` ∝ ``share``.  The
class ``weight`` lands in ``JobSpec.priority``, which the
``job_selection=priority`` policy axis reads, so class-aware admission
needs no new engine branch; ``slo_s`` is the sojourn target the windowed
metrics (``StreamResults``) grade attainment against.  Job sizes come from
the class's ``workloads.JobTemplate`` scaled uniformly in
``[scale_lo, scale_hi]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.mapreduce import JobSpec
from .workloads import JobTemplate, _scaled_job


@dataclasses.dataclass(frozen=True)
class ServiceClass:
    """One tenant class: admission weight + SLO target + job shape."""

    name: str
    weight: float = 0.0        # job_priority under job_selection=priority
    slo_s: float = math.inf    # sojourn (arrival -> done) target
    share: float = 1.0         # relative arrival share
    template: JobTemplate = JobTemplate()
    scale_lo: float = 0.5
    scale_hi: float = 2.0


DEFAULT_CLASSES: Tuple[ServiceClass, ...] = (ServiceClass("default"),)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One materialized arrival: instant, class index, lowered job."""

    t: float
    cls: int
    job: JobSpec


class ArrivalProcess:
    """Base: ``events(horizon)`` lazily yields ``Arrival``s with strictly
    increasing ``t < horizon``.  Subclasses are frozen dataclasses, so one
    process can be replayed (every ``events`` call restarts the rng)."""

    classes: Tuple[ServiceClass, ...] = DEFAULT_CLASSES

    def events(self, horizon: float) -> Iterator[Arrival]:
        raise NotImplementedError

    def _shares(self) -> np.ndarray:
        s = np.asarray([c.share for c in self.classes], float)
        if not np.all(s >= 0) or s.sum() <= 0:
            raise ValueError("class shares must be non-negative, sum > 0")
        return s / s.sum()

    def _arrival(self, rng: np.random.Generator, t: float,
                 shares: np.ndarray) -> Arrival:
        ci = int(rng.choice(len(self.classes), p=shares))
        cl = self.classes[ci]
        scale = float(rng.uniform(cl.scale_lo, cl.scale_hi))
        return Arrival(float(t), ci,
                       _scaled_job(cl.template, scale, t,
                                   priority=cl.weight))


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate`` jobs/s."""

    rate: float = 1.0
    classes: Tuple[ServiceClass, ...] = DEFAULT_CLASSES
    seed: int = 0

    def events(self, horizon: float) -> Iterator[Arrival]:
        if self.rate <= 0:
            return
        rng = np.random.default_rng(self.seed)
        shares = self._shares()
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / self.rate))
            if t >= horizon:
                return
            yield self._arrival(rng, t, shares)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Inhomogeneous Poisson with a sinusoidal day cycle, by thinning:
    candidates arrive at the peak rate ``base_rate*(1+amplitude)`` and are
    accepted with probability ``rate_at(t)/peak`` — the standard exact
    construction (Lewis & Shedler)."""

    base_rate: float = 1.0
    amplitude: float = 0.5      # in [0, 1): rate stays positive
    period: float = 86400.0
    phase: float = 0.0          # instant of mean upcrossing (sin = 0, rising)
    classes: Tuple[ServiceClass, ...] = DEFAULT_CLASSES
    seed: int = 0

    def rate_at(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amplitude
            * math.sin(2.0 * math.pi * (t - self.phase) / self.period))

    def events(self, horizon: float) -> Iterator[Arrival]:
        if self.base_rate <= 0:
            return
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        rng = np.random.default_rng(self.seed)
        shares = self._shares()
        peak = self.base_rate * (1.0 + self.amplitude)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= horizon:
                return
            if float(rng.uniform()) * peak <= self.rate_at(t):
                yield self._arrival(rng, t, shares)


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay explicit arrivals.  Either ``times`` (instants, with optional
    per-arrival ``cls_ids`` / ``scales``, jobs lowered from the class
    template) or ``jobs`` (literal ``JobSpec``s arriving at their own
    ``submit_time`` — the bit-identity test's path).  Fully deterministic:
    no rng is consumed."""

    times: Tuple[float, ...] = ()
    cls_ids: Optional[Tuple[int, ...]] = None
    scales: Optional[Tuple[float, ...]] = None
    jobs: Optional[Tuple[JobSpec, ...]] = None
    classes: Tuple[ServiceClass, ...] = DEFAULT_CLASSES

    def events(self, horizon: float) -> Iterator[Arrival]:
        if self.jobs is not None:
            seq = sorted(enumerate(self.jobs),
                         key=lambda kv: kv[1].submit_time)
            for i, job in seq:
                if job.submit_time < horizon:
                    ci = self.cls_ids[i] if self.cls_ids else 0
                    yield Arrival(float(job.submit_time), ci, job)
            return
        last = -math.inf
        for i, t in enumerate(self.times):
            if t < last:
                raise ValueError("trace times must be non-decreasing")
            last = t
            if t >= horizon:
                return
            ci = self.cls_ids[i] if self.cls_ids else 0
            cl = self.classes[ci]
            scale = self.scales[i] if self.scales else 1.0
            yield Arrival(float(t), ci,
                          _scaled_job(cl.template, scale, t,
                                      priority=cl.weight))


def as_workload(process: ArrivalProcess, horizon: float,
                max_jobs: Optional[int] = None) -> List[JobSpec]:
    """Materialize an arrival process into a finite ``JobSpec`` list — the
    bridge back to registry scenarios / ``Experiment.run`` (and the finite
    preview a streaming scenario registers)."""
    jobs: List[JobSpec] = []
    for a in process.events(horizon):
        jobs.append(a.job)
        if max_jobs is not None and len(jobs) >= max_jobs:
            break
    return jobs
