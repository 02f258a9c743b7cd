"""Failures and recovery in the port's event loop (DESIGN.md §7) against
the reference: every case of tests/test_failures.py re-run on the port
(and, where both packages can run it, held against the reference's final
state), the two ``*-failures`` registry entries under {SDN, legacy} ×
{restart, resume} × 2 seeds, and benchmarks/failure_sweep.py's grid in
small form, one port ``Experiment`` against one reference ``Experiment``.

Integer and bool leaves and ``steps`` must be equal; float leaves within
rtol 1e-6 (NaN == NaN).  On the CPU the float leaves in fact come out
equal bit for bit (the failure terms are adds, selects and mins; the
existing multiply-adds go through ``core.fp.fma32``)."""
import dataclasses

import numpy as np
import pytest

from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.core import build_setup as ref_build_setup
from repro.core import host_crash as ref_host_crash
from repro.core import no_failures as ref_no_failures
from repro.core import paper_cluster as ref_paper_cluster
from repro.core import paper_jobs as ref_paper_jobs
from repro.scenarios import get_scenario as ref_get_scenario
from repro.scenarios.failures import failure_injector as ref_injector
from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core import (RECOVERY_RESUME, ROUTE_LEGACY, ROUTE_SDN,
                              build_setup, host_crash, link_cut, no_failures,
                              paper_cluster, paper_jobs, simulate,
                              simulate_batch, summarize)
from repro_torch.core.flows import Flow, flows_setup
from repro_torch.core.mapreduce import DONE
from repro_torch.core.topology import leaf_spine, torus_2d
from repro_torch.scenarios import get_scenario
from repro_torch.scenarios.failures import failure_injector
from test_torch_engine import assert_states_match

CONC2 = dict(job_concurrency=2)


def _sim(setup, pol=None):
    return simulate(setup, pol, device="cpu")


def _with(setup, sched):
    return dataclasses.replace(setup, failures=sched)


def _dims(setup):
    topo = setup.cluster.topo
    return topo.n_hosts, topo.n_links


@pytest.fixture(scope="module")
def mini():
    """conftest.py's ``mini_setup`` in both packages: 3 paper jobs on the
    paper fabric."""
    return (build_setup(paper_jobs(seed=0, n_each=1), paper_cluster(),
                        split=2, device="cpu"),
            ref_build_setup(ref_paper_jobs(seed=0, n_each=1),
                            ref_paper_cluster(), split=2))


def _both(mini, sched_fn, pols):
    """The port's and the reference's ``[1, P, ...]`` states for the same
    schedule (``sched_fn(host_crash-like ctor)``) and policies."""
    port, ref = mini
    p = Experiment(_with(port, sched_fn(host_crash, port)),
                   [PolicyConfig(**k) for k in pols], device="cpu").run()
    r = RefExperiment(_with(ref, sched_fn(ref_host_crash, ref)),
                      [RefPolicyConfig(**k) for k in pols]).run()
    return p, type(r.states)(*(np.asarray(a) for a in r.states))


def _bitwise(a, b, label=""):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{label}{name}"
        np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                      err_msg=f"{label}{name}")


def test_all_inf_schedule_bit_identical(mini):
    """The no-failure schedule IS the healthy engine, bitwise, and an
    all-inf replica inside a grid whose other replica fails (so the grid
    runs every failure term) equals the healthy run too."""
    port, _ = mini
    pol = PolicyConfig(**CONC2)
    base = _sim(port, pol)
    _bitwise(_sim(_with(port, no_failures(*_dims(port))), pol), base,
             "all-inf: ")
    res = Experiment(port, pol, device="cpu", failures=[
        ("none", no_failures(*_dims(port))),
        ("crash", host_crash(*_dims(port), host=0, at=30.0,
                             recover_at=300.0))]).run()
    assert res.meta.has_failures
    _bitwise(res.state(0, 0), base, "all-inf in a failing grid: ")


def test_conservation_and_clock_after_reexecution(mini):
    """§4 invariants survive a host outage, and the state equals the
    reference's."""
    p, r = _both(mini, lambda hc, s: hc(*_dims(s), host=0, at=30.0,
                                        recover_at=300.0), [CONC2])
    assert_states_match(p.states, r, "host crash")
    s = p.state()
    port = mini[0]
    assert not bool(s.stalled)
    assert np.all(s.task_state.numpy()[port.task_valid] == DONE)
    assert np.all(s.pkt_state.numpy()[port.pkt_valid] == DONE)
    assert np.all((s.pkt_finish - s.pkt_start).numpy()[port.pkt_valid]
                  >= -1e-5)
    assert float(s.time) > 0
    assert int(s.task_restarts.sum()) >= 1


def test_dead_host_draws_zero_power(mini):
    p, r = _both(mini, lambda hc, s: hc(*_dims(s), host=0, at=1.0), [CONC2])
    assert_states_match(p.states, r, "permanent crash")
    s = p.state()
    port = mini[0]
    assert not bool(s.stalled)
    base = _sim(port, PolicyConfig(**CONC2))
    assert float(s.host_energy[0]) < float(base.host_energy[0])
    assert np.all(s.task_state.numpy()[port.task_valid] == DONE)


def test_stall_on_permanent_disconnect():
    topo = torus_2d(2, 1, bw=1e9)
    setup = flows_setup(topo, [Flow(0, 1, 8.0)], device="cpu")
    sched = link_cut(topo.n_hosts, topo.n_links, [0, 1], at=2.0)
    s = _sim(_with(setup, sched), PolicyConfig())
    assert bool(s.stalled)
    assert float(s.time) == pytest.approx(2.0, rel=1e-5)


def test_transient_link_cut_resumes():
    topo = torus_2d(2, 1, bw=1e9)
    setup = flows_setup(topo, [Flow(0, 1, 8.0)], device="cpu")
    sched = link_cut(topo.n_hosts, topo.n_links, [0, 1], at=2.0,
                     recover_at=10.0)
    s = _sim(_with(setup, sched), PolicyConfig())
    assert not bool(s.stalled)
    # 2 s transferred, 8 s outage, 6 s remaining -> done at 16
    assert float(s.time) == pytest.approx(16.0, rel=1e-3)
    assert float(s.job_downtime.sum()) == pytest.approx(8.0, rel=1e-3)


def test_sdn_reroutes_legacy_pins():
    """SDN routes around a cut spine; the legacy static hash can keep
    forwarding into it and waits out the outage."""
    topo = leaf_spine(2, 2, 2)
    setup = flows_setup(topo, [Flow(0, 2, 8.0)], device="cpu")
    times = {}
    for spine in (0, 1):
        cut = topo.links_touching(topo.switch(spine))
        sched = link_cut(topo.n_hosts, topo.n_links, cut, at=2.0,
                         recover_at=500.0)
        for name, routing in (("sdn", ROUTE_SDN), ("legacy", ROUTE_LEGACY)):
            s = _sim(_with(setup, sched), PolicyConfig(routing=routing))
            assert not bool(s.stalled)
            times[(name, spine)] = float(s.time)
    for spine in (0, 1):
        assert times[("sdn", spine)] == pytest.approx(8.0, rel=1e-3)
    assert max(times[("legacy", 0)], times[("legacy", 1)]) > 100.0


def test_recovery_resume_not_slower_than_restart(mini):
    p, r = _both(mini, lambda hc, s: hc(*_dims(s), host=0, at=50.0,
                                        recover_at=400.0),
                 [CONC2, dict(recovery=RECOVERY_RESUME, **CONC2)])
    assert_states_match(p.states, r, "restart/resume")
    restart, resume = p.state(0, 0), p.state(0, 1)
    assert not bool(restart.stalled) and not bool(resume.stalled)
    assert float(resume.time) <= float(restart.time) + 1e-3


def test_batch_single_bit_equality_with_failures(mini):
    port, _ = mini
    sf = _with(port, host_crash(*_dims(port), host=2, at=40.0,
                                recover_at=200.0))
    sb = simulate_batch(sf, {"routing": np.asarray([ROUTE_SDN,
                                                    ROUTE_LEGACY]),
                             "job_concurrency": np.asarray([2, 2])},
                        device="cpu")
    for i, routing in enumerate((ROUTE_SDN, ROUTE_LEGACY)):
        si = _sim(sf, PolicyConfig(routing=routing, **CONC2))
        _bitwise(type(si)(*(a[i] for a in sb)), si, f"lane {i}: ")


def test_total_outage_defers_admission(mini):
    def every_host(hc, s):
        sched = hc(*_dims(s), host=0, at=0.0, recover_at=50.0)
        sched.host_fail_t[:] = 0.0
        sched.host_recover_t[:] = 50.0
        return sched
    p, r = _both(mini, every_host, [CONC2])
    assert_states_match(p.states, r, "total outage")
    s = p.state()
    assert not bool(s.stalled)
    assert np.nanmin(s.job_admit_t.numpy()) >= 50.0
    assert np.all(s.task_state.numpy()[mini[0].task_valid] == DONE)


def test_recovery_metrics_in_report(mini):
    port, _ = mini
    s = _sim(_with(port, host_crash(*_dims(port), host=0, at=30.0,
                                    recover_at=300.0)),
             PolicyConfig(**CONC2))
    rep = summarize(port, s)
    for key in ("task_reexecs", "pkt_reroutes", "downtime_s"):
        assert key in rep and rep[key].shape == (port.n_jobs,)
    assert int(rep["task_reexecs"].sum()) == int(s.task_restarts.sum())


def test_experiment_failure_axis(mini):
    """Experiment(failures=...) replicates the scenario per schedule; the
    rows carry the recovery metrics and equal the reference's."""
    port, ref = mini
    pols = [("sdn", dict(routing=ROUTE_SDN, **CONC2)),
            ("legacy", dict(routing=ROUTE_LEGACY, **CONC2))]
    inj = dict(host_rate=3e-4, link_rate=3e-4, mttr=120.0, horizon=2000.0,
               seed=1)
    res = Experiment(("mini", port),
                     [(n, PolicyConfig(**k)) for n, k in pols],
                     failures=[("none", no_failures(*_dims(port))),
                               ("r1", failure_injector(**inj))],
                     device="cpu").run()
    want = RefExperiment(
        ("mini", ref), [(n, RefPolicyConfig(**k)) for n, k in pols],
        failures=[("none", ref_no_failures(*_dims(ref))),
                  ("r1", ref_injector(**inj))]).run()
    assert res.n_scenarios == 2 and res.n_policies == 2 and len(res) == 4
    assert res.scenario_names == want.scenario_names == ["mini/none",
                                                         "mini/r1"]
    rows = res.rows()
    assert len(rows) == 4
    for row, ref_row in zip(rows, want.rows()):
        assert not row["stalled"]
        for k, v in ref_row.items():
            if isinstance(v, float):
                np.testing.assert_allclose(row[k], v, rtol=1e-6, err_msg=k)
            else:
                assert row[k] == v, k
    none_rows = [r for r in rows if r["scenario"].endswith("none")]
    assert none_rows and all(r["task_reexecs"] == 0 and r["pkt_reroutes"] == 0
                             for r in none_rows)
    assert sum(r["task_reexecs"] + r["pkt_reroutes"] for r in rows) > 0


def test_failed_scenario_registry_entries():
    """Both entries build the reference's schedule, draw for draw."""
    for name in ("paper-fabric-failures", "leaf-spine-failures"):
        setup = get_scenario(name).build("cpu")
        want = ref_get_scenario(name).build().failures
        assert setup.failures is not None and setup.failures.any_failures
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(setup.failures, f.name),
                                          getattr(want, f.name),
                                          err_msg=f"{name}: {f.name}")
    lf = get_scenario("leaf-spine-failures").build("cpu").failures.link_fail_t
    assert np.array_equal(lf[0::2], lf[1::2], equal_nan=True)


GRID_POLICIES = [dict(routing=r, recovery=rec, **CONC2)
                 for r in (ROUTE_SDN, ROUTE_LEGACY) for rec in (0, 1)]


@pytest.mark.parametrize("name", ["paper-fabric-failures",
                                  "leaf-spine-failures"])
@pytest.mark.parametrize("seed", [0, 1])
def test_failure_scenarios_equal_reference(name, seed):
    """{SDN, legacy} × {restart, resume} as four lanes of one run."""
    port = Experiment(get_scenario(name, seed=seed).build("cpu"),
                      [PolicyConfig(**k) for k in GRID_POLICIES],
                      device="cpu").run()
    ref = RefExperiment(ref_get_scenario(name, seed=seed).build(),
                        [RefPolicyConfig(**k) for k in GRID_POLICIES]).run()
    assert port.meta.has_failures
    assert_states_match(port.states, type(ref.states)(
        *(np.asarray(a) for a in ref.states)), f"{name}/seed{seed}")
    reverts = int(port.states.pkt_reroutes.sum()
                  + port.states.task_restarts.sum())
    assert seed == 1 and name == "leaf-spine-failures" or reverts > 0


def test_failure_sweep_grid_equals_reference():
    """benchmarks/failure_sweep.py's grid, small: paper-fabric × rates
    {0, 2e-4, 1e-3} × 2 trace seeds × {SDN, legacy}, one Experiment."""
    def grid(exp_cls, pol_cls, inj):
        return exp_cls(
            "paper-fabric",
            [("sdn", pol_cls(routing=ROUTE_SDN, **CONC2)),
             ("legacy", pol_cls(routing=ROUTE_LEGACY, **CONC2))],
            failures=[(f"r{rate:g}/s{s}",
                       inj(host_rate=rate, link_rate=rate, mttr=120.0,
                           horizon=5000.0, seed=s))
                      for rate in (0.0, 2e-4, 1e-3) for s in range(2)],
            **({} if exp_cls is RefExperiment else {"device": "cpu"}))
    port = grid(Experiment, PolicyConfig, failure_injector).run()
    ref = grid(RefExperiment, RefPolicyConfig, ref_injector).run()
    assert port.scenario_names == ref.scenario_names
    assert port.meta.max_steps == ref.meta.max_steps
    assert_states_match(port.states, type(ref.states)(
        *(np.asarray(a) for a in ref.states)), "failure sweep")
    rows = port.rows()
    assert not any(r["stalled"] for r in rows)
    for r in rows[:4]:                 # rate 0: no recovery activity
        assert r["task_reexecs"] == r["pkt_reroutes"] == 0
    assert sum(r["pkt_reroutes"] for r in rows[4:]) > 0
