"""The port's packed multi-scenario grid (``repro_torch.scenarios.sweep``,
``repro_torch.api.runners``) and the rest of the front door against the
reference: the four-scenario heterogeneous grid, ``pack_setups`` /
``slice_packed`` leaf by leaf, pad slots inert and each packed scenario
equal to its own single run on its unpadded prefix, the engine's public
entries (``simulate``, ``simulate_batch``, ``simulate_scenarios``,
``init_state``) against ``Experiment``, the runner cache's LRU bound, the
consts cache, ``Results``' counts and cells, and ``failures`` given
positionally.

Integer and bool leaves must be equal, float leaves within rtol 1e-6; on
the CPU the grid's floats come out equal bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from invariants import check_pad_inert
from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.core.engine import init_state as ref_init_state
from repro.scenarios import get_scenario as ref_get_scenario
from repro.scenarios import pack_setups as ref_pack_setups
from repro.scenarios import sweep_grid as ref_sweep_grid
from repro_torch.api import (Experiment, PolicyConfig, consts_build_count,
                             consts_cache_clear, runners)
from repro_torch.core import (ROUTE_LEGACY, ROUTE_SDN, host_crash,
                              init_state, make_consts, no_failures,
                              simulate, simulate_batch, simulate_scenarios)
from repro_torch.core.engine import SimState
from repro_torch.scenarios import (get_scenario, pack_setups, policy_arrays,
                                   sweep_grid)
from repro_torch.scenarios.sweep import slice_packed
from test_torch_engine import RTOL, assert_states_match
from test_torch_failures import _bitwise

FOUR = ["paper-fabric", "leaf-spine", "fat-tree", "canonical-tree"]
PAIR = [("sdn", dict(routing=ROUTE_SDN)), ("legacy", dict(routing=ROUTE_LEGACY))]


def _np_states(states):
    return type(states)(*(np.asarray(a) for a in states))


@pytest.fixture(scope="module")
def setups():
    """The four fabrics in both packages, the port's on the CPU."""
    port = [get_scenario(n).build("cpu") for n in FOUR]
    ref = [ref_get_scenario(n).build() for n in FOUR]
    return port, ref


@pytest.fixture(scope="module")
def grids():
    port = Experiment(FOUR, [(n, PolicyConfig(**k)) for n, k in PAIR],
                      device="cpu").run()
    ref = RefExperiment(FOUR, [(n, RefPolicyConfig(**k)) for n, k in PAIR]
                        ).run()
    return port, ref


def test_grid_equals_reference(grids):
    port, ref = grids
    assert port.scenario_names == ref.scenario_names
    assert port.policy_names == ref.policy_names
    assert (port.n_scenarios, port.n_policies, len(port)) == (4, 2, 8)
    # one engine loop per scenario, each timed
    loops = runners.get_runner(port.meta, "grid").seconds
    assert len(loops) == 4 and all(t > 0 for t in loops)
    assert port.meta == dataclasses.replace(
        port.meta, **{f.name: getattr(ref.meta, f.name)
                      for f in dataclasses.fields(ref.meta)
                      if f.name != "energy"})
    assert_states_match(port.states, _np_states(ref.states), "grid")
    for name, p, r in zip(port.consts._fields, port.consts, ref.consts):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype and p.shape == r.shape, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
    for prow, rrow in zip(port.rows(), ref.rows()):
        assert prow.keys() == rrow.keys()
        for k, v in rrow.items():
            if isinstance(v, float):
                np.testing.assert_allclose(prow[k], v, rtol=RTOL, err_msg=k)
            else:
                assert prow[k] == v, k
    pj, rj = port.job_report(), ref.job_report()
    for k in rj:
        np.testing.assert_allclose(pj[k], rj[k], rtol=RTOL, atol=0,
                                   equal_nan=True, err_msg=k)


def test_results_cells(grids):
    """``state(s, p)`` is every cell of the ``[S, P, ...]`` grid; pad jobs
    read NaN in the report."""
    port, _ = grids
    for si in range(port.n_scenarios):
        for pi in range(port.n_policies):
            cell = port.state(si, pi)
            for name, a, leaf in zip(cell._fields, cell, port.states):
                assert torch.equal(a.nan_to_num(7.0),
                                   leaf[si, pi].nan_to_num(7.0)), name
            s = port.summary(si, pi)
            assert int(s["steps"]) == int(cell.steps)
    jr = port.job_report()["completion_measured"]
    valid = np.broadcast_to(port.consts.job_valid.numpy()[:, None, :],
                            jr.shape)
    assert not valid.all()                  # the grid has pad jobs
    assert np.all(np.isnan(jr[~valid])) and np.all(np.isfinite(jr[valid]))


def _unpack_pair(pair, dims_packed, topo):
    """A packed pair index back to the scenario's own node numbering."""
    H, SW, Nn = dims_packed
    n_h, n_sw, n = topo.n_hosts, topo.n_switches, topo.n_nodes

    def back(ids):
        return np.where(ids < H, ids, np.where(
            ids < H + SW, ids - H + n_h, ids - H - SW + n_h + n_sw))
    src, dst = back(pair // Nn), back(pair % Nn)
    return np.where(pair >= 0, src * n + dst, -1).astype(np.int32)


def test_pad_inert_and_prefix_equals_single_run(setups, grids):
    """Each packed scenario equals its own single run on its unpadded
    prefix (node pairs mapped back), and its pad slots stay inert."""
    port, _ = grids
    meta = port.meta
    for si, setup in enumerate(setups[0]):
        c = slice_packed(port.consts, si)
        single = Experiment(setup, [PolicyConfig(**k) for _, k in PAIR],
                            device="cpu").run()
        for pi in range(port.n_policies):
            packed, one = port.state(si, pi), single.state(0, pi)
            check_pad_inert(c, meta, packed, label=f"{FOUR[si]}/{pi}")
            for name, a, b in zip(one._fields, packed, one):
                a = a.numpy()
                if name == "pkt_pair":
                    a = _unpack_pair(a, (meta.n_hosts, meta.n_switches,
                                         meta.n_nodes), setup.cluster.topo)
                prefix = a[tuple(slice(0, n) for n in b.shape)]
                np.testing.assert_array_equal(
                    prefix, b.numpy(), err_msg=f"{FOUR[si]}/{pi}: {name}")
            n_h = setup.cluster.topo.n_hosts
            n_sw = setup.cluster.topo.n_switches
            assert not packed.host_energy[n_h:].any()
            assert not packed.switch_energy[n_sw:].any()


def test_pack_setups_equals_reference(setups):
    """Leaf by leaf, with a live failure schedule on one scenario, and each
    ``slice_packed`` view equal to the reference's slice."""
    port, ref = setups
    topo = port[2].cluster.topo
    crash = dict(host=1, at=20.0, recover_at=90.0)
    port = [*port[:2], dataclasses.replace(port[2], failures=host_crash(
        topo.n_hosts, topo.n_links, **crash))]
    from repro.core import host_crash as ref_host_crash
    ref = [*ref[:2], dataclasses.replace(ref[2], failures=ref_host_crash(
        topo.n_hosts, topo.n_links, **crash))]
    consts, meta = pack_setups(port, device="cpu")
    rconsts, rmeta = ref_pack_setups(ref)
    for f in dataclasses.fields(rmeta):
        if f.name != "energy":
            assert getattr(meta, f.name) == getattr(rmeta, f.name), f.name
    assert meta.has_failures
    for si in range(3):
        sl = slice_packed(consts, si)
        for name, p, r in zip(sl._fields, sl, rconsts):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r)[si],
                                          err_msg=f"{si}: {name}")
            assert p.shape == np.asarray(r).shape[1:], name


def test_public_entries_equal_experiment(setups):
    """``simulate``, ``simulate_batch`` and ``simulate_scenarios`` against
    ``Experiment``'s cells; ``init_state`` against the reference's."""
    port = setups[0][:2]
    pols = [PolicyConfig(**k) for _, k in PAIR]
    res = Experiment(port, pols, device="cpu").run()
    for si, setup in enumerate(port):
        batch = simulate_batch(setup, policy_arrays(pols), device="cpu")
        for pi, pol in enumerate(pols):
            one = simulate(setup, pol, device="cpu")
            _bitwise(SimState(*(a[pi] for a in batch)), one,
                     f"batch {si}/{pi}: ")
            assert int(one.steps) == int(res.state(si, pi).steps)
    consts, meta = pack_setups(port, device="cpu")
    zipped = simulate_scenarios(consts, meta, policy_arrays(pols))
    for r in range(2):
        _bitwise(SimState(*(a[r] for a in zipped)), res.state(r, r),
                 f"zipped {r}: ")
    s0 = init_state(port[1], device="cpu")
    want = ref_init_state(setups[1][1])
    assert_states_match(s0, _np_states(want), "init_state")


def test_runner_cache_is_lru_bounded(setups):
    runners.cache_clear()
    _, meta = make_consts(setups[0][0], device="cpu")
    for i in range(runners.CACHE_MAX + 5):
        runners.get_runner(dataclasses.replace(
            meta, max_steps=meta.max_steps + i), "single")
    assert runners.cache_size() == runners.CACHE_MAX
    first = runners.get_runner(meta, "grid")
    assert runners.get_runner(meta, "grid") is first
    with pytest.raises(ValueError):
        runners.get_runner(meta, "fleet")
    runners.cache_clear()
    assert runners.cache_size() == 0


def test_consts_cache_keyed_by_names_and_device():
    consts_cache_clear()
    a = Experiment(["paper-fabric", "canonical-tree"], device="cpu")
    b = Experiment(["paper-fabric", "canonical-tree"], device="cpu")
    assert a.build() is a.build()
    a.build(), b.build()
    assert consts_build_count() == 1
    # a failure cross replaces schedules after the build: never cached
    topo = a.scenarios[0][1].cluster.topo
    Experiment("paper-fabric", device="cpu", failures=no_failures(
        topo.n_hosts, topo.n_links)).build()
    Experiment("paper-fabric", device="cpu", failures=no_failures(
        topo.n_hosts, topo.n_links)).build()
    assert consts_build_count() == 3
    consts_cache_clear()
    assert consts_build_count() == 0


def test_failures_positional(setups):
    """The reference's positional order: ``(scenarios, policies, seeds,
    failures, ctrl, degradation)``; ``device`` is keyword only."""
    setup = setups[0][0]
    topo = setup.cluster.topo
    sched = host_crash(topo.n_hosts, topo.n_links, host=0, at=30.0,
                       recover_at=300.0)
    exp = Experiment(setup, PolicyConfig(job_concurrency=2), None,
                     [("a", sched), ("b", no_failures(topo.n_hosts,
                                                      topo.n_links))],
                     device="cpu")
    assert exp.scenario_names == ["scenario/a", "scenario/b"]
    assert exp.scenarios[0][1].failures is sched
    with pytest.raises(TypeError, match="FailureSchedule"):
        # a device in the fourth place is read as the failure axis
        Experiment(setup, None, None, "cpu", device="cpu")


def test_sweep_grid_equals_reference(setups):
    port, ref = setups
    names = ["x", "y"]
    pols = [("p", dict(job_concurrency=2))]
    got = sweep_grid(list(zip(names, port[:2])),
                     [(n, PolicyConfig(**k)) for n, k in pols], device="cpu")
    want = ref_sweep_grid(list(zip(names, ref[:2])),
                          [(n, RefPolicyConfig(**k)) for n, k in pols])
    assert got.scenario_names == want.scenario_names == ["x", "y"]
    assert_states_match(got.states, _np_states(want.states), "sweep_grid")
    for g, w in zip(got.rows(), want.rows()):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)
            else:
                assert g[k] == v, k
