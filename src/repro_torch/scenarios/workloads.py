"""Synthetic MapReduce workload generators (DESIGN.md §5).

Port of ``src/repro/scenarios/workloads.py`` (numpy copy).

The paper's §5 use-case fixes one 15-job trace (Table 3).  These generators
produce parameterized ``JobSpec`` lists layered on ``core.mapreduce``:

  * ``uniform_workload``  — job sizes i.i.d. uniform around a base spec,
  * ``zipf_workload``     — heavy-tailed (Zipf) size distribution: many small
                            jobs, few elephants (the measured shape of
                            production MapReduce traces),
  * ``bursty_workload``   — arrivals clustered into bursts separated by idle
                            gaps (stress test for admission + SDN routing
                            under synchronized shuffles).

All are deterministic in ``seed`` (np.random.RandomState) so scenario sweeps
are reproducible replica-for-replica.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.mapreduce import JobSpec


@dataclasses.dataclass(frozen=True)
class JobTemplate:
    """Base shape a generator scales; defaults ≈ the paper's 'medium' job
    scaled down ~20x so sweep smoke-runs stay cheap."""

    n_map: int = 2
    n_reduce: int = 1
    map_mi: float = 10_000.0
    reduce_mi: float = 8_000.0
    input_gbits: float = 20.0
    shuffle_gbits: float = 16.0
    output_gbits: float = 12.0


def _scaled_job(tmpl: JobTemplate, scale: float, submit: float,
                priority: float = 0.0) -> JobSpec:
    """Scale compute+data linearly; parallelism grows as sqrt(scale) so big
    jobs get more mappers instead of only fatter ones."""
    par = max(1, int(round(np.sqrt(scale))))
    return JobSpec(
        submit_time=float(submit),
        n_map=tmpl.n_map * par,
        n_reduce=max(1, tmpl.n_reduce * par),
        map_mi=tmpl.map_mi * scale / par,
        reduce_mi=tmpl.reduce_mi * scale / par,
        input_gbits=tmpl.input_gbits * scale,
        shuffle_gbits=tmpl.shuffle_gbits * scale,
        output_gbits=tmpl.output_gbits * scale,
        priority=priority,
    )


def uniform_workload(n_jobs: int = 6, seed: int = 0, interval_s: float = 1.0,
                     scale_lo: float = 0.5, scale_hi: float = 2.0,
                     template: JobTemplate = JobTemplate()) -> List[JobSpec]:
    """i.i.d. uniform job sizes, fixed submission interval."""
    rng = np.random.RandomState(seed)
    scales = rng.uniform(scale_lo, scale_hi, size=n_jobs)
    return [_scaled_job(template, s, i * interval_s)
            for i, s in enumerate(scales)]


def zipf_workload(n_jobs: int = 6, seed: int = 0, interval_s: float = 1.0,
                  alpha: float = 1.6, max_scale: float = 8.0,
                  template: JobTemplate = JobTemplate()) -> List[JobSpec]:
    """Zipf-distributed sizes clipped to ``max_scale`` — mostly rank-1
    (scale 1) jobs with an occasional elephant."""
    rng = np.random.RandomState(seed)
    scales = np.minimum(rng.zipf(alpha, size=n_jobs).astype(np.float64),
                        max_scale)
    return [_scaled_job(template, s, i * interval_s)
            for i, s in enumerate(scales)]


def bursty_workload(n_jobs: int = 6, seed: int = 0, burst_size: int = 3,
                    burst_gap_s: float = 60.0, intra_gap_s: float = 0.1,
                    scale_lo: float = 0.5, scale_hi: float = 2.0,
                    template: JobTemplate = JobTemplate()) -> List[JobSpec]:
    """Jobs arrive ``burst_size`` at a time, ``intra_gap_s`` apart inside a
    burst and ``burst_gap_s`` between bursts."""
    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(n_jobs):
        burst, pos = divmod(i, burst_size)
        t = burst * burst_gap_s + pos * intra_gap_s
        jobs.append(_scaled_job(template, rng.uniform(scale_lo, scale_hi), t))
    return jobs
