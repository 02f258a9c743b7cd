"""Gray failures, speculation and controller failover in the port's event
loop (DESIGN.md §13) against the reference: every case of
tests/test_chaos.py re-run on the port and held against the reference's
final state where both packages run it, the two ``*-chaos`` registry
entries under {SDN, legacy} × speculation {off, on} × 2 seeds,
benchmarks/chaos_sweep.py's grid in small form, and the off switch: an
identity ``CtrlPlaneConfig``, a unity-factor degradation schedule and no
clone slots give the plain path's state bit for bit.
``tests/invariants.py``'s ``check_ctrl``, ``check_chaos`` and
``check_finite`` run on every port state, and ``check_stream`` on the
chaos stack streamed through ``Experiment.run_stream``.

Integer and bool leaves and ``steps`` must be equal; float leaves within
rtol 1e-6 (NaN == NaN).  On the CPU they come out bitwise equal: the
gray windows are multiplies and selects, the clones' remaining work goes
through ``core.fp.fma32`` as XLA contracts it, and the clone-slot sums
(``spec_wasted``, the clones' MIPS per host) add at most two non-zero
terms a step here, which any order sums alike."""
import dataclasses

import numpy as np
import pytest

from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.core import CtrlPlaneConfig as RefCtrlPlaneConfig
from repro.core import build_setup as ref_build_setup
from repro.core import host_slowdown as ref_host_slowdown
from repro.core import link_brownout as ref_link_brownout
from repro.core import no_degradation as ref_no_degradation
from repro.core.flows import Flow as RefFlow
from repro.core.flows import flows_setup as ref_flows_setup
from repro.core.topology import leaf_spine as ref_leaf_spine
from repro.core.topology import torus_2d as ref_torus_2d
from repro.scenarios import get_scenario as ref_get_scenario
from repro.scenarios import make_cluster as ref_make_cluster
from repro.scenarios import uniform_workload as ref_uniform_workload
from repro.scenarios.workloads import JobTemplate as RefJobTemplate
from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core import (PLACE_ROUND_ROBIN, ROUTE_LEGACY, ROUTE_SDN,
                              SPEC_OFF, SPEC_ON, CtrlPlaneConfig, build_setup,
                              host_slowdown, link_brownout, no_ctrl,
                              no_degradation, no_failures, simulate)
from repro_torch.core.engine import make_consts
from repro_torch.core.flows import Flow, flows_setup
from repro_torch.core.topology import leaf_spine, torus_2d
from repro_torch.scenarios import (JobTemplate, get_scenario, make_cluster,
                                   uniform_workload)
from repro_torch.scenarios.failures import random_degradation
from test_torch_ctrlplane import (as_numpy, both, check_grid, check_port,
                                  ref_states, torch_equal)
from test_torch_engine import assert_states_match
from invariants import check_chaos, check_finite

CONC2 = dict(job_concurrency=2)


@pytest.fixture(scope="module")
def mini():
    from repro.core import paper_cluster as ref_paper_cluster
    from repro.core import paper_jobs as ref_paper_jobs
    from repro_torch.core import paper_cluster, paper_jobs
    return (build_setup(paper_jobs(seed=0, n_each=1), paper_cluster(),
                        split=2, device="cpu"),
            ref_build_setup(ref_paper_jobs(seed=0, n_each=1),
                            ref_paper_cluster(), split=2))


def dims(setup):
    return setup.cluster.topo.n_hosts, setup.cluster.topo.n_links


def degraded(pair, port_sched, ref_sched, **kw):
    return (dataclasses.replace(pair[0], degradation=port_sched, **kw),
            dataclasses.replace(pair[1], degradation=ref_sched, **kw))


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_failure_validate_rejects_zero_length_window():
    sched = no_failures(4, 8)
    sched.host_fail_t[1] = 10.0
    sched.host_recover_t[1] = 10.0
    with pytest.raises(ValueError, match="recover_t <= fail_t"):
        sched.validate(4, 8)
    sched = no_failures(4, 8)
    sched.link_fail_t[3] = 5.0
    sched.link_recover_t[3] = 2.0
    with pytest.raises(ValueError, match="recover_t <= fail_t"):
        sched.validate(4, 8)


def test_degradation_validate_rejections():
    s = no_degradation(4, 8)
    s.host_slow_t[0] = 10.0
    s.host_restore_t[0] = 10.0
    s.host_factor[0] = 0.5
    with pytest.raises(ValueError, match="restore_t <= slow_t"):
        s.validate(4, 8)
    for field, value in (("link_factor", 0.0), ("host_factor", np.inf)):
        s = no_degradation(4, 8)
        getattr(s, field.replace("factor", "slow_t"))[1] = 1.0
        getattr(s, field)[1] = value
        with pytest.raises(ValueError):
            s.validate(4, 8)
    with pytest.raises(AssertionError, match="shape"):
        no_degradation(4, 8).validate(5, 8)


# ---------------------------------------------------------------------------
# degradation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("restore", [np.inf, 6.0])
def test_link_brownout_exact_piecewise_rate(restore):
    """A factor-0.5 brownout from t = 2 on the only cable: 2 s at full
    rate and the rest at half (done at 14), or back to full at t = 6
    (done at 10)."""
    pair = (flows_setup(torus_2d(2, 1, bw=1e9), [Flow(0, 1, 8.0)],
                        device="cpu"),
            ref_flows_setup(ref_torus_2d(2, 1, bw=1e9), [RefFlow(0, 1, 8.0)]))
    n_h, n_l = dims(pair[0])
    s = both(*degraded(pair, link_brownout(n_h, n_l, [0, 1], at=2.0,
                                           factor=0.5, restore_at=restore),
                       ref_link_brownout(n_h, n_l, [0, 1], at=2.0,
                                         factor=0.5, restore_at=restore)),
             [{}]).state()
    assert not bool(s.stalled)
    want_t, want_deg = (14.0, 12.0) if np.isinf(restore) else (10.0, 4.0)
    assert float(s.time) == pytest.approx(want_t, rel=1e-3)
    assert float(s.degraded_time) == pytest.approx(want_deg, rel=1e-3)


def test_host_slowdown_stretches_compute(mini):
    n_h, n_l = dims(mini[0])
    scheds = []
    for ctor in (no_degradation, ref_no_degradation):
        sched = ctor(n_h, n_l)
        sched.host_slow_t[:] = 0.0
        sched.host_factor[:] = 0.5
        scheds.append(sched.validate(n_h, n_l))
    setups = degraded(mini, *scheds)
    slow = both(*setups, [CONC2]).state()
    base = simulate(mini[0], PolicyConfig(**CONC2), device="cpu")
    assert not bool(slow.stalled)
    assert float(slow.time) > float(base.time)
    assert float(slow.degraded_time) == pytest.approx(float(slow.time),
                                                      rel=1e-5)
    c, meta = make_consts(setups[0], device="cpu")
    check_port(c, meta, slow, "host-slowdown", everything=True)


def test_unity_factor_schedule_bit_identical(mini):
    n_h, n_l = dims(mini[0])
    sched = no_degradation(n_h, n_l)
    sched.host_slow_t[:] = 3.0
    sched.host_restore_t[:] = 9.0
    assert not sched.validate(n_h, n_l).any_degradation
    pol = PolicyConfig(**CONC2)
    base = simulate(mini[0], pol, device="cpu")
    unit = simulate(dataclasses.replace(mini[0], degradation=sched), pol,
                    device="cpu")
    for name, a, b in zip(base._fields, base, unit):
        assert torch_equal(a, b), name


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------


def straggler_pair(spec_slots):
    """4-host leaf-spine, host 0 at 5 % MIPS from t = 0: round-robin puts
    2 of 6 maps on it, crawling while healthy peers expose them."""
    out = []
    for ls, mc, slowdown, tmpl, wl, build in (
            (leaf_spine, make_cluster, host_slowdown, JobTemplate,
             uniform_workload, lambda *a, **k: build_setup(
                 *a, **k, device="cpu")),
            (ref_leaf_spine, ref_make_cluster, ref_host_slowdown,
             RefJobTemplate, ref_uniform_workload, ref_build_setup)):
        topo = ls(2, 2, 2)
        out.append(build(
            wl(n_jobs=1, seed=0, template=tmpl(n_map=6, n_reduce=2)),
            mc(topo), degradation=slowdown(topo.n_hosts, topo.n_links,
                                           host=0, at=0.0, factor=0.05),
            spec_slots=spec_slots))
    return tuple(out)


SPEC_PAIR = [dict(placement=PLACE_ROUND_ROBIN, speculation=SPEC_OFF),
             dict(placement=PLACE_ROUND_ROBIN, speculation=SPEC_ON)]


def test_speculation_beats_straggler():
    pair = straggler_pair(spec_slots=2)
    p = both(*pair, SPEC_PAIR)
    off, on = p.state(0, 0), p.state(0, 1)
    assert not bool(off.stalled) and not bool(on.stalled)
    assert int(on.spec_launches) >= 1 and int(on.spec_wins) >= 1
    assert float(on.time) < float(off.time)
    assert float(on.spec_wasted) > 0.0
    assert int(off.spec_launches) == int(off.spec_wins) == 0
    assert float(off.spec_wasted) == 0.0
    c, meta = make_consts(pair[0], device="cpu")
    for label, s in (("spec-on", on), ("spec-off", off)):
        check_port(c, meta, s, label, everything=True)


def test_speculation_policy_inert_without_slots():
    p = both(*straggler_pair(spec_slots=0), SPEC_PAIR)
    for name, a, b in zip(p.states._fields, p.state(0, 0), p.state(0, 1)):
        assert torch_equal(a, b), name


def test_clone_never_slower_tie_goes_to_original():
    setups = (build_setup(uniform_workload(n_jobs=2, seed=0),
                          make_cluster(leaf_spine(2, 2, 2)), spec_slots=2,
                          device="cpu"),
              ref_build_setup(ref_uniform_workload(n_jobs=2, seed=0),
                              ref_make_cluster(ref_leaf_spine(2, 2, 2)),
                              spec_slots=2))
    p = both(*setups, [dict(speculation=SPEC_OFF), dict(speculation=SPEC_ON)])
    assert float(p.state(0, 1).time) <= float(p.state(0, 0).time) + 1e-3


# ---------------------------------------------------------------------------
# controller failover
# ---------------------------------------------------------------------------


def test_failover_parks_requests_and_counts(mini):
    base_cfg = dict(install_latency=0.05, ctrl_rate=500.0, table_slots=8)
    fo_cfg = dict(base_cfg, ctrl_fail_t=0.0, ctrl_recover_t=1e9,
                  failover_delay=5.0, backup_rate=50.0, backup_latency=0.5)
    runs = {}
    for label, cfg in (("base", base_cfg), ("fo", fo_cfg)):
        setups = (dataclasses.replace(mini[0], ctrl=CtrlPlaneConfig(**cfg)),
                  dataclasses.replace(mini[1],
                                      ctrl=RefCtrlPlaneConfig(**cfg)))
        runs[label] = both(*setups, [CONC2]).state()
    base, fo = runs["base"], runs["fo"]
    assert not bool(fo.stalled)
    assert int(fo.ctrl_failovers) == 1
    assert float(fo.ctrl_failover_park) > 0.0
    assert float(fo.time) > float(base.time)
    assert int(base.ctrl_failovers) == 0
    assert float(base.ctrl_failover_park) == 0.0
    c, meta = make_consts(dataclasses.replace(
        mini[0], ctrl=CtrlPlaneConfig(**fo_cfg)), device="cpu")
    check_port(c, meta, fo, "failover", everything=True)


def test_failover_validate_rejections():
    for bad in (dict(ctrl_fail_t=10.0, ctrl_recover_t=5.0),
                dict(ctrl_fail_t=10.0, failover_delay=-1.0),
                dict(ctrl_fail_t=10.0, backup_rate=0.0)):
        with pytest.raises(ValueError):
            CtrlPlaneConfig(**bad).validate()


# ---------------------------------------------------------------------------
# the invariants catch doctored port states; the report's columns
# ---------------------------------------------------------------------------


def test_check_finite_catches_doctored_nan(mini):
    c, meta = make_consts(mini[0], device="cpu")
    c = as_numpy(c)
    s = as_numpy(simulate(mini[0], PolicyConfig(**CONC2), device="cpu"))
    check_finite(c, meta, s)
    for field, value in (("task_rem", np.nan), ("host_energy", np.inf),
                         ("task_start", np.inf)):
        arr = getattr(s, field).copy()
        arr[0] = value
        with pytest.raises(AssertionError, match=field):
            check_finite(c, meta, s._replace(**{field: arr}))


def test_check_chaos_catches_doctored_counters(mini):
    c, meta = make_consts(mini[0], device="cpu")
    c = as_numpy(c)
    s = as_numpy(simulate(mini[0], PolicyConfig(**CONC2), device="cpu"))
    check_chaos(c, meta, s)
    for field, value, msg in (
            ("spec_launches", np.int32(3), "without clone slots"),
            ("degraded_time", np.float32(1.0), "degradation schedule"),
            ("ctrl_failovers", np.int32(1), "ctrl plane off")):
        with pytest.raises(AssertionError, match=msg):
            check_chaos(c, meta, s._replace(**{field: value}))


def test_chaos_rows_metrics():
    res = Experiment("leaf-spine", [("sdn", PolicyConfig(
        routing=ROUTE_SDN, **CONC2))], device="cpu").run()
    row = res.rows()[0]
    for key in ("spec_launches", "spec_wins", "wasted_spec_work_s",
                "degraded_time_s", "failover_count", "failover_park_s"):
        assert row[key] == 0, key


def test_chaos_scenarios_registered():
    """Both entries build the reference's schedules, draw for draw."""
    for name in ("paper-fabric-chaos", "leaf-spine-chaos"):
        setup = get_scenario(name).build("cpu")
        want = ref_get_scenario(name).build()
        assert setup.degradation.any_degradation and setup.spec_slots > 0
        assert setup.spec_slots == want.spec_slots
        for f in dataclasses.fields(want.degradation):
            np.testing.assert_array_equal(
                getattr(setup.degradation, f.name),
                getattr(want.degradation, f.name), err_msg=f"{name}: {f}")
        assert (setup.ctrl is None) == (want.ctrl is None)
        if want.ctrl is not None:
            assert dataclasses.asdict(setup.ctrl) == \
                dataclasses.asdict(want.ctrl)
    deg = get_scenario("paper-fabric-chaos").build("cpu").degradation
    assert np.array_equal(deg.link_slow_t[0::2], deg.link_slow_t[1::2],
                          equal_nan=True)


# ---------------------------------------------------------------------------
# registry entries, the sweep's grid, the off switch
# ---------------------------------------------------------------------------


CHAOS_POLICIES = [dict(routing=r, speculation=sp, **CONC2)
                  for r in (ROUTE_SDN, ROUTE_LEGACY)
                  for sp in (SPEC_OFF, SPEC_ON)]


@pytest.mark.parametrize("name", ["paper-fabric-chaos", "leaf-spine-chaos"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_scenarios_equal_reference(name, seed):
    """{SDN, legacy} × speculation {off, on} as lanes of one run."""
    p = both(get_scenario(name, seed=seed).build("cpu"),
             ref_get_scenario(name, seed=seed).build(), CHAOS_POLICIES)
    assert p.meta.has_degradation and p.meta.spec_slots == 2
    assert p.meta.has_ctrl == (name == "paper-fabric-chaos")
    st = p.states
    assert int(st.spec_launches[0, 0]) == int(st.spec_launches[0, 2]) == 0
    assert float(st.degraded_time.min()) > 0.0
    if name == "paper-fabric-chaos":
        assert bool((st.ctrl_failovers == 1).all())


def test_chaos_sweep_grid_equals_reference():
    """benchmarks/chaos_sweep.py's grid, small: leaf-spine-chaos ×
    severities {0.2, 0.5} × 2 trace seeds × {SDN, legacy} × speculation
    {off, on}, one Experiment over the four scenarios."""
    def grid(exp_cls, pol_cls, get, **kw):
        build = (lambda sc: sc.build("cpu")) if kw else \
            (lambda sc: sc.build())
        scens = [(f"sev{sev:g}-s{seed}", build(get(
            "leaf-spine-chaos", mean_factor=sev, seed=seed, spec_slots=2)))
            for sev in (0.2, 0.5) for seed in range(2)]
        return exp_cls(scens, [pol_cls(**k) for k in CHAOS_POLICIES],
                       **kw).run()
    port = grid(Experiment, PolicyConfig, get_scenario, device="cpu")
    ref = grid(RefExperiment, RefPolicyConfig, ref_get_scenario)
    assert port.scenario_names == ref.scenario_names
    assert port.meta.max_steps == ref.meta.max_steps
    assert_states_match(port.states, ref_states(ref), "chaos sweep")
    rows = port.rows()
    assert not any(r["stalled"] for r in rows)
    assert sum(r["spec_launches"] for r in rows) > 0
    check_grid(port, "chaos sweep")


def test_degradation_and_ctrl_axes_equal_reference(mini):
    """``Experiment(degradation=..., ctrl=...)`` crosses as the
    reference's: the gray traces × two configs, names and states."""
    from repro.scenarios.failures import degradation_injector as ref_inj
    from repro_torch.scenarios.failures import degradation_injector as inj
    kw = dict(host_rate=2e-3, link_rate=1e-3, mean_factor=0.3, mttr=200.0,
              horizon=1500.0)
    cfgs = [("fast", dict(install_latency=0.005, ctrl_rate=2000.0,
                          table_slots=4)),
            ("slow", dict(install_latency=0.1, ctrl_rate=200.0))]
    pols = [dict(routing=ROUTE_SDN, **CONC2),
            dict(routing=ROUTE_LEGACY, **CONC2)]
    port = Experiment(("mini", mini[0]), [PolicyConfig(**k) for k in pols],
                      degradation=[(f"g{s}", inj(seed=s, **kw))
                                   for s in range(2)],
                      ctrl=[(n, CtrlPlaneConfig(**c)) for n, c in cfgs],
                      device="cpu").run()
    ref = RefExperiment(("mini", mini[1]),
                        [RefPolicyConfig(**k) for k in pols],
                        degradation=[(f"g{s}", ref_inj(seed=s, **kw))
                                     for s in range(2)],
                        ctrl=[(n, RefCtrlPlaneConfig(**c))
                              for n, c in cfgs]).run()
    assert port.scenario_names == ref.scenario_names == [
        "mini/g0/fast", "mini/g0/slow", "mini/g1/fast", "mini/g1/slow"]
    assert port.meta.ctrl_slots == 4
    assert_states_match(port.states, ref_states(ref), "axes")
    check_grid(port, "axes")


def test_random_degradation_draws_the_reference_schedule():
    from repro.scenarios.failures import random_degradation as ref_random
    topo, ref_topo = leaf_spine(4, 4, 4), ref_leaf_spine(4, 4, 4)
    for kw in (dict(host_rate=2e-3, mean_factor=0.3, mttr=400.0,
                    horizon=2000.0, seed=1),
               dict(host_rate=1e-3, link_rate=1e-3, mean_factor=0.02,
                    seed=5)):
        got, want = random_degradation(topo, **kw), ref_random(ref_topo, **kw)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name))
        assert got.n_events == want.n_events


@pytest.mark.parametrize("name", ["paper-fabric", "leaf-spine"])
def test_off_switch_is_the_plain_path(name):
    """An identity ``CtrlPlaneConfig``, a degradation schedule whose
    windows all have factor 1 and no clone slots turn no ``SimMeta``
    switch on, and the state equals the plain run bit for bit, across
    placement × routing × speculation."""
    plain = get_scenario(name).build("cpu")
    n_h, n_l = dims(plain)
    unity = no_degradation(n_h, n_l)
    unity.host_slow_t[:] = 1.0
    unity.link_slow_t[:] = 2.0
    off = dataclasses.replace(plain, ctrl=no_ctrl(), degradation=unity,
                              spec_slots=0)
    pols = [PolicyConfig(placement=pl, routing=r, speculation=sp, **CONC2)
            for pl in range(3) for r in (ROUTE_SDN, ROUTE_LEGACY)
            for sp in (SPEC_OFF, SPEC_ON)]
    a = Experiment(plain, pols, device="cpu").run()
    b = Experiment(off, pols, device="cpu").run()
    assert a.meta == b.meta
    assert not (b.meta.has_ctrl or b.meta.has_degradation
                or b.meta.spec_slots)
    for field, x, y in zip(a.states._fields, a.states, b.states):
        assert torch_equal(x, y), field


def test_chaos_composition_through_run_stream():
    """Outages × degradation × controller failover × speculation, streamed
    through the slot-recycling ring: conservation holds, the run drains,
    the chaos counters surface in ``StreamResults.summary``, and every job
    row, sample, counter and final state equals the reference's."""
    from repro.core import host_crash as ref_host_crash
    from repro.scenarios.arrivals import ServiceClass as RefServiceClass
    from repro.scenarios.arrivals import TraceArrivals as RefTraceArrivals
    from repro_torch.core import host_crash
    from repro_torch.scenarios.arrivals import ServiceClass, TraceArrivals
    from invariants import check_stream
    from test_torch_streaming import assert_stream_equal

    def stream(pkg):
        port = pkg == "port"
        setup = (get_scenario("leaf-spine", n_jobs=2).build("cpu") if port
                 else ref_get_scenario("leaf-spine", n_jobs=2).build())
        n_h, n_l = dims(setup)
        deg = (host_slowdown if port else ref_host_slowdown)(
            n_h, n_l, host=0, at=0.0, factor=0.1)
        fail = (host_crash if port else ref_host_crash)(
            n_h, n_l, host=1, at=20.0, recover_at=60.0)
        ctrl = (CtrlPlaneConfig if port else RefCtrlPlaneConfig)(
            install_latency=0.02, ctrl_rate=1000.0, table_slots=8,
            ctrl_fail_t=10.0, ctrl_recover_t=1e9, failover_delay=1.0,
            backup_rate=200.0, backup_latency=0.1)
        chaos_setup = dataclasses.replace(setup, degradation=deg,
                                          failures=fail, ctrl=ctrl,
                                          spec_slots=2)
        arrivals = (TraceArrivals if port else RefTraceArrivals)(
            times=tuple(4.0 * i for i in range(8)),
            classes=((ServiceClass if port else RefServiceClass)(
                "only", slo_s=500.0,
                template=(JobTemplate if port else RefJobTemplate)(
                    n_map=2, n_reduce=1)),))
        pol = (PolicyConfig if port else RefPolicyConfig)(
            routing=ROUTE_SDN, placement=PLACE_ROUND_ROBIN,
            speculation=SPEC_ON, job_concurrency=2)
        exp = (Experiment(("chaos-stream", chaos_setup), [("spec-on", pol)],
                          device="cpu") if port else
               RefExperiment(("chaos-stream", chaos_setup),
                             [("spec-on", pol)]))
        return exp.run_stream(arrivals, horizon=30.0, slots=4,
                              chunk_steps=64, return_states=True)

    res = stream("port")
    assert res.stats.refills > 0         # the ring actually recycled
    check_stream(res, label="chaos-stream")
    summ = res.summary(0)
    assert summ["failover_count"] >= 1
    assert summ["degraded_time_s"] > 0.0
    assert summ["spec_launches"] >= summ["spec_wins"] >= 0
    assert_stream_equal(res, stream("ref"), "chaos-stream")
