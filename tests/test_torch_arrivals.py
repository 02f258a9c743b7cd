"""The port's open-arrival processes (``repro_torch.scenarios.arrivals``,
DESIGN.md §11): every case of tests/test_arrivals.py re-run on the port,
and each process's trace held against the reference's for the same
parameters and seed: the same instants, classes and jobs, float for float
(both draw from ``np.random.default_rng(seed)`` in the same order)."""
import dataclasses
import math

import numpy as np
import pytest

from repro.scenarios import arrivals as ref_arrivals
from repro.scenarios.workloads import JobTemplate as RefJobTemplate
from repro.scenarios.workloads import uniform_workload as ref_uniform_workload
from repro_torch.scenarios.arrivals import (DEFAULT_CLASSES, DiurnalArrivals,
                                            PoissonArrivals, ServiceClass,
                                            TraceArrivals, as_workload)
from repro_torch.scenarios.workloads import JobTemplate, uniform_workload


def _trace(proc, horizon):
    return list(proc.events(horizon))


def _same_trace(port, ref):
    """Arrival by arrival: instant, class and every JobSpec field equal."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.t == b.t and a.cls == b.cls
        assert dataclasses.asdict(a.job) == dataclasses.asdict(b.job)


# ---------------------------------------------------------------------------
# determinism / replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda s: PoissonArrivals(rate=0.8, seed=s),
    lambda s: DiurnalArrivals(base_rate=0.8, amplitude=0.6, period=50.0,
                              phase=7.0, seed=s),
])
def test_seed_determinism_and_replay(make):
    a = _trace(make(3), 200.0)
    b = _trace(make(3), 200.0)          # fresh events() call: replays
    c = _trace(make(4), 200.0)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.t == y.t and x.cls == y.cls and x.job == y.job
    assert [x.t for x in a] != [x.t for x in c]   # seed actually matters
    ts = np.asarray([x.t for x in a])
    assert np.all(np.diff(ts) > 0) and ts[-1] < 200.0
    d = _trace(make(3), 400.0)
    assert [x.t for x in d[:len(a)]] == [x.t for x in a]


def test_empirical_poisson_rate():
    rate, horizon = 2.0, 4000.0
    n = len(_trace(PoissonArrivals(rate=rate, seed=0), horizon))
    mean = rate * horizon
    assert abs(n - mean) < 5.0 * math.sqrt(mean)


def test_diurnal_rate_modulation_period_and_phase():
    p = DiurnalArrivals(base_rate=2.0, amplitude=0.8, period=100.0,
                        phase=10.0, seed=1)
    assert p.rate_at(10.0) == pytest.approx(2.0)
    assert p.rate_at(35.0) == pytest.approx(2.0 * 1.8)
    assert p.rate_at(85.0) == pytest.approx(2.0 * 0.2)
    ts = np.asarray([a.t for a in _trace(p, 4000.0)])
    phase_of = (ts - 10.0) % 100.0
    peak = np.sum((phase_of >= 12.5) & (phase_of < 37.5))
    trough = np.sum((phase_of >= 62.5) & (phase_of < 87.5))
    assert peak > 2.0 * trough
    assert abs(len(ts) - 2.0 * 4000.0) < 5.0 * math.sqrt(2.0 * 4000.0)


def test_diurnal_amplitude_validation():
    with pytest.raises(ValueError, match="amplitude"):
        _trace(DiurnalArrivals(base_rate=1.0, amplitude=1.0), 10.0)


# ---------------------------------------------------------------------------
# trace replay / round trip
# ---------------------------------------------------------------------------


def test_trace_jobs_round_trip():
    jobs = uniform_workload(n_jobs=5, seed=2, interval_s=3.0)
    shuffled = tuple(jobs[i] for i in (3, 0, 4, 1, 2))
    out = as_workload(TraceArrivals(jobs=shuffled), horizon=1e9)
    assert out == sorted(jobs, key=lambda j: j.submit_time)
    short = as_workload(TraceArrivals(jobs=shuffled), horizon=6.5)
    assert [j.submit_time for j in short] == [0.0, 3.0, 6.0]


def test_trace_times_lowers_from_class_template():
    cls = (ServiceClass("a", weight=2.0, template=JobTemplate(n_map=4)),
           ServiceClass("b", template=JobTemplate(n_map=2)))
    tr = TraceArrivals(times=(1.0, 2.0, 5.0), cls_ids=(0, 1, 0),
                       scales=(1.0, 1.0, 4.0), classes=cls)
    evs = _trace(tr, 10.0)
    assert [a.t for a in evs] == [1.0, 2.0, 5.0]
    assert [a.cls for a in evs] == [0, 1, 0]
    assert evs[0].job.n_map == 4 and evs[1].job.n_map == 2
    assert evs[2].job.n_map == 8          # par = sqrt(4) = 2
    assert evs[0].job.priority == 2.0 and evs[1].job.priority == 0.0
    with pytest.raises(ValueError, match="non-decreasing"):
        _trace(TraceArrivals(times=(2.0, 1.0)), 10.0)


# ---------------------------------------------------------------------------
# service classes
# ---------------------------------------------------------------------------


def test_class_shares_and_priority_threading():
    cls = (ServiceClass("batch", share=3.0, weight=0.0),
           ServiceClass("urgent", share=1.0, weight=5.0, slo_s=30.0))
    evs = _trace(PoissonArrivals(rate=2.0, classes=cls, seed=5), 2000.0)
    ci = np.asarray([a.cls for a in evs])
    frac_urgent = float(np.mean(ci == 1))
    assert abs(frac_urgent - 0.25) < 0.05
    pri = np.asarray([a.job.priority for a in evs])
    assert np.all(pri[ci == 1] == 5.0) and np.all(pri[ci == 0] == 0.0)


def test_class_share_validation():
    bad = (ServiceClass("x", share=-1.0),)
    with pytest.raises(ValueError, match="share"):
        _trace(PoissonArrivals(rate=1.0, classes=bad, seed=0), 10.0)
    assert DEFAULT_CLASSES[0].slo_s == math.inf


def test_as_workload_max_jobs():
    w = as_workload(PoissonArrivals(rate=1.0, seed=0), horizon=1e6,
                    max_jobs=7)
    assert len(w) == 7
    assert all(w[i].submit_time < w[i + 1].submit_time for i in range(6))


# ---------------------------------------------------------------------------
# the same traces as the reference
# ---------------------------------------------------------------------------


def _classes(mod, tmpl):
    """Two classes with distinct templates, weights, SLOs and scale ranges."""
    return (mod.ServiceClass("batch", weight=0.0, slo_s=600.0, share=0.7),
            mod.ServiceClass("urgent", weight=2.0, slo_s=120.0, share=0.3,
                             template=tmpl(n_map=2, n_reduce=1),
                             scale_lo=0.25, scale_hi=1.0))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", ["poisson", "diurnal", "trace-times",
                                  "trace-jobs"])
def test_trace_equals_reference(kind, seed):
    from repro_torch.scenarios import arrivals as port_arrivals

    def make(mod, tmpl, workload):
        cls = _classes(mod, tmpl)
        if kind == "poisson":
            return mod.PoissonArrivals(rate=0.4, classes=cls, seed=seed)
        if kind == "diurnal":
            return mod.DiurnalArrivals(base_rate=0.5, amplitude=0.7,
                                       period=300.0, phase=20.0,
                                       classes=cls, seed=seed)
        if kind == "trace-times":
            rng = np.random.default_rng(seed)
            times = tuple(np.cumsum(rng.exponential(2.0, 40)).tolist())
            return mod.TraceArrivals(
                times=times, cls_ids=tuple(int(c) for c in
                                           rng.integers(0, 2, 40)),
                scales=tuple(rng.uniform(0.5, 3.0, 40).tolist()),
                classes=cls)
        return mod.TraceArrivals(jobs=tuple(workload(n_jobs=9, seed=seed)))

    port = make(port_arrivals, JobTemplate, uniform_workload)
    ref = make(ref_arrivals, RefJobTemplate, ref_uniform_workload)
    for horizon in (50.0, 400.0):
        _same_trace(_trace(port, horizon), _trace(ref, horizon))
    assert [dataclasses.asdict(j) for j in as_workload(port, 400.0, 5)] \
        == [dataclasses.asdict(j) for j in ref_arrivals.as_workload(
            ref, 400.0, 5)]
