"""The control plane in the port's event loop (DESIGN.md §10) against the
reference: every case of tests/test_ctrlplane.py re-run on the port and
held against the reference's final state where both packages run it, the
two ``*-ctrl`` registry entries under {SDN reactive, SDN proactive,
legacy} (plus SDN with migration=congestion on ``leaf-spine-ctrl``) × 2
seeds, benchmarks/ctrl_sweep.py's grid in small form, and a mixed grid of
a plain and a priced scenario held cell by cell against each scenario's
own run.  ``tests/invariants.py``'s ``check_ctrl``, ``check_chaos`` and
``check_finite`` run on every port state.

Integer and bool leaves and ``steps`` must be equal; float leaves within
rtol 1e-6 (NaN == NaN).  On the CPU they in fact come out bitwise equal:
the controller's terms are adds, divisions, selects and maxima, and the
flow-table writes touch distinct cells."""
import dataclasses

import numpy as np
import pytest

from invariants import check_all, check_chaos, check_ctrl, check_finite
from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.core import CtrlPlaneConfig as RefCtrlPlaneConfig
from repro.core import build_setup as ref_build_setup
from repro.core import host_crash as ref_host_crash
from repro.core import paper_cluster as ref_paper_cluster
from repro.core import paper_jobs as ref_paper_jobs
from repro.core.flows import Flow as RefFlow
from repro.core.flows import flows_setup as ref_flows_setup
from repro.core.topology import leaf_spine as ref_leaf_spine
from repro.scenarios import get_scenario as ref_get_scenario
from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core import (INSTALL_PROACTIVE, MIG_CONGESTION, ROUTE_LEGACY,
                              ROUTE_SDN, CtrlPlaneConfig, build_setup,
                              host_crash, no_ctrl, paper_cluster, paper_jobs,
                              simulate)
from repro_torch.core.engine import make_consts
from repro_torch.core.flows import Flow, flows_setup
from repro_torch.core.topology import leaf_spine
from repro_torch.scenarios import get_scenario
from test_torch_engine import assert_states_match

CONC2 = dict(job_concurrency=2)
CTRL = dict(install_latency=0.05, ctrl_rate=500.0, table_slots=8)


def as_numpy(tree):
    """A NamedTuple of tensors (consts or a state) as numpy arrays."""
    return type(tree)(*(np.asarray(a.cpu()) for a in tree))


def check_port(c, meta, s, label, everything=False):
    """``invariants.py``'s ctrl, chaos and finite checks (or all of them)
    on one unbatched port state."""
    c, s = as_numpy(c), as_numpy(s)
    if everything:
        check_all(c, meta, s, label=label)
    for fn in (check_ctrl, check_chaos, check_finite):
        fn(c, meta, s, label=label)


def check_grid(res, label):
    for si, sn in enumerate(res.scenario_names):
        c = type(res.consts)(*(a[si] for a in res.consts))
        for pi, pn in enumerate(res.policy_names):
            check_port(c, res.meta, res.state(si, pi),
                       f"{label} {sn}/{pn}")


def ref_states(res):
    return type(res.states)(*(np.asarray(a) for a in res.states))


def both(port_setup, ref_setup, pols):
    """The port's and the reference's ``[1, P, ...]`` runs of the same
    setup pair under the same policies, held leaf by leaf."""
    p = Experiment(port_setup, [PolicyConfig(**k) for k in pols],
                   device="cpu").run()
    r = RefExperiment(ref_setup, [RefPolicyConfig(**k) for k in pols]).run()
    assert_states_match(p.states, ref_states(r))
    check_grid(p, "port")
    return p


def ctrl(port_setup, ref_setup, **cfg):
    return (dataclasses.replace(port_setup, ctrl=CtrlPlaneConfig(**cfg)),
            dataclasses.replace(ref_setup, ctrl=RefCtrlPlaneConfig(**cfg)))


@pytest.fixture(scope="module")
def mini():
    """conftest.py's ``mini_setup`` in both packages."""
    return (build_setup(paper_jobs(seed=0, n_each=1), paper_cluster(),
                        split=2, device="cpu"),
            ref_build_setup(ref_paper_jobs(seed=0, n_each=1),
                            ref_paper_cluster(), split=2))


def flow_pair(n_spine, n_leaf, hosts, flows):
    return (flows_setup(leaf_spine(n_spine, n_leaf, hosts),
                        [Flow(*f) for f in flows], device="cpu"),
            ref_flows_setup(ref_leaf_spine(n_spine, n_leaf, hosts),
                            [RefFlow(*f) for f in flows]))


@pytest.fixture(scope="module")
def ls_flow():
    """One 8-second flow crossing 3 switches (leaf, spine, leaf)."""
    return flow_pair(2, 2, 2, [(0, 2, 8.0)])


def test_config_validation_and_any_ctrl():
    assert not no_ctrl().any_ctrl
    assert not CtrlPlaneConfig().any_ctrl
    for cfg in (CtrlPlaneConfig(install_latency=0.1),
                CtrlPlaneConfig(ctrl_rate=100.0),
                CtrlPlaneConfig(table_slots=4),
                CtrlPlaneConfig(mig_threshold=8.0)):
        assert cfg.any_ctrl
    for bad in (dict(install_latency=-1.0), dict(ctrl_rate=0.0),
                dict(table_slots=-1)):
        with pytest.raises(ValueError):
            CtrlPlaneConfig(**bad).validate()


def test_identity_config_is_the_off_switch(ls_flow):
    port, _ = ls_flow
    _, meta_none = make_consts(port, device="cpu")
    _, meta_id = make_consts(dataclasses.replace(port, ctrl=no_ctrl()),
                             device="cpu")
    assert not meta_none.has_ctrl and meta_none == meta_id
    a = simulate(port, PolicyConfig(), device="cpu")
    b = simulate(dataclasses.replace(port, ctrl=no_ctrl()), PolicyConfig(),
                 device="cpu")
    for name, x, y in zip(a._fields, a, b):
        assert torch_equal(x, y), name


def torch_equal(x, y):
    return np.array_equal(x.numpy(), y.numpy(), equal_nan=True)


@pytest.mark.parametrize("lat", [0.25, 1.5])
def test_install_latency_delays_exactly(ls_flow, lat):
    p = both(*ctrl(*ls_flow, install_latency=lat), [{}])
    s = p.state()
    assert not bool(s.stalled)
    assert float(s.time) == pytest.approx(8.0 + lat, rel=1e-4)
    assert float(s.pkt_install_wait.sum()) == pytest.approx(lat, rel=1e-4)


def test_legacy_routing_bypasses_controller(ls_flow):
    pol = [dict(routing=ROUTE_LEGACY)]
    p = both(*ctrl(*ls_flow, install_latency=0.5, ctrl_rate=50.0,
                   table_slots=2), pol)
    base = simulate(ls_flow[0], PolicyConfig(**pol[0]), device="cpu")
    s = p.state()
    assert int(s.ctrl_installs) == 0
    assert float(s.time) == float(base.time)
    assert float(s.pkt_install_wait.sum()) == 0.0


def test_rate_limited_controller_serializes_installs():
    setups = flow_pair(2, 2, 2, [(0, 2, 8.0), (1, 3, 8.0)])
    fast = both(*ctrl(*setups, install_latency=0.01), [{}]).state()
    slow = both(*ctrl(*setups, install_latency=0.01, ctrl_rate=2.0),
                [{}]).state()
    assert not bool(slow.stalled)
    assert float(slow.ctrl_queue_wait) > 0.0
    assert float(fast.ctrl_queue_wait) == 0.0
    assert float(slow.time) > float(fast.time)


def test_lru_table_evicts_and_conserves():
    """One slot per switch: the second flow through the spine displaces
    the first's rule, and ``occupied == installs - evictions``."""
    setups = flow_pair(1, 2, 2, [(0, 2, 4.0), (1, 3, 4.0)])
    s = both(*ctrl(*setups, install_latency=0.01, table_slots=1),
             [{}]).state()
    assert not bool(s.stalled)
    assert int(s.ctrl_evictions) >= 1
    occupied = int((s.ftab_pair >= 0).sum())
    assert occupied == int(s.ctrl_installs) - int(s.ctrl_evictions)


def test_tableless_conservation(ls_flow):
    s = both(*ctrl(*ls_flow, install_latency=0.1), [{}]).state()
    assert int(s.ctrl_installs) > 0
    assert int(s.ctrl_installs) == int(s.ctrl_evictions)
    assert s.ftab_pair.numel() == 0


def test_proactive_overlaps_install_latency(mini):
    p = both(*ctrl(*mini, **CTRL),
             [CONC2, dict(install_mode=INSTALL_PROACTIVE, **CONC2)])
    react, pro = p.state(0, 0), p.state(0, 1)
    assert not bool(react.stalled) and not bool(pro.stalled)
    assert float(pro.time) < float(react.time)
    c, meta = make_consts(dataclasses.replace(
        mini[0], ctrl=CtrlPlaneConfig(**CTRL)), device="cpu")
    check_port(c, meta, pro, "paper-fabric/proactive", everything=True)
    check_port(c, meta, react, "paper-fabric/reactive", everything=True)


def test_legacy_beats_sdn_under_priced_controller(mini):
    pols = [dict(routing=ROUTE_SDN, **CONC2),
            dict(routing=ROUTE_LEGACY, **CONC2)]
    p = both(*ctrl(*mini, **CTRL), pols)
    sdn, legacy = p.state(0, 0), p.state(0, 1)
    assert not bool(sdn.stalled) and not bool(legacy.stalled)
    assert float(legacy.time) < float(sdn.time)
    free = both(*mini, pols)
    assert float(free.state(0, 0).time) < float(free.state(0, 1).time)


def test_migration_rehomes_and_completes():
    setup = get_scenario("leaf-spine-ctrl").build("cpu")
    p = both(setup, ref_get_scenario("leaf-spine-ctrl").build(),
             [dict(routing=ROUTE_SDN, migration=MIG_CONGESTION),
              dict(routing=ROUTE_SDN)])
    mig, static = p.state(0, 0), p.state(0, 1)
    assert not bool(mig.stalled) and not bool(static.stalled)
    assert int(mig.vm_migrations.sum()) > 0
    assert int(static.vm_migrations.sum()) == 0
    c, meta = make_consts(setup, device="cpu")
    assert not torch_equal(mig.vm_host, c.vm_host)
    assert torch_equal(static.vm_host, c.vm_host)
    check_port(c, meta, mig, "leaf-spine-ctrl/mig", everything=True)


def test_ctrl_composes_with_failures(mini):
    port, ref = mini
    n_h, n_l = port.cluster.topo.n_hosts, port.cluster.topo.n_links
    port = dataclasses.replace(port, failures=host_crash(
        n_h, n_l, host=0, at=30.0, recover_at=300.0))
    ref = dataclasses.replace(ref, failures=ref_host_crash(
        n_h, n_l, host=0, at=30.0, recover_at=300.0))
    p = both(*ctrl(port, ref, **CTRL), [CONC2])
    s = p.state()
    assert not bool(s.stalled)
    assert int(s.task_restarts.sum()) >= 1
    assert p.meta.has_ctrl and p.meta.has_failures
    check_port(type(p.consts)(*(a[0] for a in p.consts)), p.meta, s,
               "paper-fabric/failures+ctrl", everything=True)


def test_ctrl_metrics_reported(mini):
    """rows() carries the §10 columns, zero without a config; the plain
    scenario of the packed grid never moves a VM."""
    port, ref = mini
    pol = [("sdn", dict(routing=ROUTE_SDN, **CONC2))]
    res = Experiment(
        [("plain", port), ("priced", dataclasses.replace(
            port, ctrl=CtrlPlaneConfig(**CTRL)))],
        [(n, PolicyConfig(**k)) for n, k in pol], device="cpu").run()
    want = RefExperiment(
        [("plain", ref), ("priced", dataclasses.replace(
            ref, ctrl=RefCtrlPlaneConfig(**CTRL)))],
        [(n, RefPolicyConfig(**k)) for n, k in pol]).run()
    assert_states_match(res.states, ref_states(want), "plain/priced")
    rows = {r["scenario"]: r for r in res.rows()}
    assert rows["plain"]["rule_installs"] == 0
    assert rows["plain"]["install_wait_s"] == 0.0
    assert rows["priced"]["rule_installs"] > 0
    assert rows["priced"]["install_wait_s"] > 0.0
    for row, ref_row in zip(res.rows(), want.rows()):
        assert row.keys() == ref_row.keys()
        for k, v in ref_row.items():
            if isinstance(v, float):
                np.testing.assert_allclose(row[k], v, rtol=1e-6, err_msg=k)
            else:
                assert row[k] == v, k
    n_vms = int(res.consts.n_vms[0])
    assert torch_equal(res.state(0, 0).vm_host[:n_vms],
                       res.consts.vm_host[0][:n_vms])
    check_grid(res, "metrics")


CTRL_POLICIES = [dict(routing=ROUTE_SDN, **CONC2),
                 dict(routing=ROUTE_SDN, install_mode=INSTALL_PROACTIVE,
                      **CONC2),
                 dict(routing=ROUTE_LEGACY, **CONC2)]


@pytest.mark.parametrize("name", ["paper-fabric-ctrl", "leaf-spine-ctrl"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ctrl_scenarios_equal_reference(name, seed):
    """{SDN reactive, SDN proactive, legacy} (and SDN with migration on
    leaf-spine-ctrl) as lanes of one run."""
    pols = CTRL_POLICIES + ([dict(routing=ROUTE_SDN, migration=MIG_CONGESTION,
                                  **CONC2)]
                            if name == "leaf-spine-ctrl" else [])
    p = both(get_scenario(name, seed=seed).build("cpu"),
             ref_get_scenario(name, seed=seed).build(), pols)
    assert p.meta.has_ctrl and p.meta.ctrl_slots == 8
    installs = p.states.ctrl_installs[0]
    assert int(installs[0]) > 0 and int(installs[2]) == 0


def test_ctrl_registry_entries_build_the_reference_config():
    for name in ("paper-fabric-ctrl", "leaf-spine-ctrl"):
        got = get_scenario(name).build("cpu").ctrl
        want = ref_get_scenario(name).build().ctrl
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def test_ctrl_sweep_grid_equals_reference():
    """benchmarks/ctrl_sweep.py's grid, small: paper-fabric × install
    latencies {0.005, 0.05} × {SDN, SDN proactive, legacy}, one
    Experiment, the ctrl axis crossing the scenario."""
    def grid(exp_cls, pol_cls, cfg_cls, **kw):
        return exp_cls(
            "paper-fabric",
            [("sdn", pol_cls(routing=ROUTE_SDN, **CONC2)),
             ("sdn-pro", pol_cls(routing=ROUTE_SDN,
                                 install_mode=INSTALL_PROACTIVE, **CONC2)),
             ("legacy", pol_cls(routing=ROUTE_LEGACY, **CONC2))],
            ctrl=[(f"lat{lat:g}", cfg_cls(install_latency=lat,
                                          ctrl_rate=500.0, table_slots=8))
                  for lat in (0.005, 0.05)], **kw).run()
    port = grid(Experiment, PolicyConfig, CtrlPlaneConfig, device="cpu")
    ref = grid(RefExperiment, RefPolicyConfig, RefCtrlPlaneConfig)
    assert port.scenario_names == ref.scenario_names == [
        "paper-fabric/lat0.005", "paper-fabric/lat0.05"]
    for f in ("max_steps", "has_ctrl", "ctrl_slots", "has_failures"):
        assert getattr(port.meta, f) == getattr(ref.meta, f), f
    assert_states_match(port.states, ref_states(ref), "ctrl sweep")
    rows = port.rows()
    assert not any(r["stalled"] for r in rows)
    assert all(r["rule_installs"] == 0 for r in rows
               if r["policy"] == "legacy")
    check_grid(port, "ctrl sweep")


def test_mixed_grid_cells_equal_their_own_runs():
    """["paper-fabric", "paper-fabric-ctrl"] in one packed grid: the grid
    runs the controller's terms for both, the plain scenario's lanes with
    ``ctrl_on`` false and zero counters; each cell equals its scenario's
    own run and the reference's grid."""
    names = ["paper-fabric", "paper-fabric-ctrl"]
    pols = [PolicyConfig(**k) for k in CTRL_POLICIES]
    grid = Experiment(names, pols, device="cpu").run()
    ref = RefExperiment(names, [RefPolicyConfig(**k)
                                for k in CTRL_POLICIES]).run()
    assert grid.meta.has_ctrl
    assert_states_match(grid.states, ref_states(ref), "mixed grid")
    for si, name in enumerate(names):
        own = Experiment(name, pols, device="cpu").run()
        for pi in range(len(pols)):
            cell, single = grid.state(si, pi), own.state(0, pi)
            for field, a, b in zip(cell._fields, cell, single):
                if field.startswith("ftab_"):
                    # the plain scenario runs with the grid's table width
                    assert b.numel() == 0 or torch_equal(a, b), field
                    continue
                assert torch_equal(a, b), f"{name}/{pi}: {field}"
    plain = grid.states
    assert int(plain.ctrl_installs[0].sum()) == 0
    assert bool((plain.ftab_pair[0] < 0).all())
    check_grid(grid, "mixed grid")
