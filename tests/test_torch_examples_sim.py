"""The port's simulator entry scripts (``examples/torch_quickstart.py``'s
first part, ``torch_sdn_vs_legacy.py``, ``torch_policy_sweep.py``,
``torch_scenario_zoo.py``) on the CPU against the reference, which the
test drives through ``repro`` directly (never through ``examples/*.py``
or ``benchmarks/``): integers and flags exact, floats at rtol 1e-6 (the
engine's tolerance; energy totals sum in another order).  Every script
imports nothing of jax, ``repro`` or ``benchmarks``, and without
``--device`` it runs on CUDA, so on a machine without a card it raises.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.api import Experiment as RefExperiment
from repro.core import (JOBSEL_FCFS, JOBSEL_SJF, PLACE_LEAST_USED,
                        PLACE_RANDOM, ROUTE_LEGACY, ROUTE_SDN,
                        TRAFFIC_FAIRSHARE, TRAFFIC_WATERFILL)
from repro.core import PolicyConfig as RefPolicyConfig
from repro.core import paper_setup as ref_paper_setup
from repro.scenarios import get_scenario as ref_get_scenario

import torch_examples

RTOL = 1e-6
CPU = torch.device("cpu")
SCRIPTS = ("torch_quickstart", "torch_sdn_vs_legacy", "torch_policy_sweep",
           "torch_scenario_zoo", "torch_serve_lm", "torch_train_lm")
SIM_SCRIPTS = SCRIPTS[:4]


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: under the suite's parallel
    workers, each PyTorch process's default of a thread a core
    oversubscribes the CPU, and its many small ops then wait on each
    other (six concurrent 16-lane policy sweeps at 8 threads each did not
    finish in 200 s on an 8-core CPU, against ~7 s each at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, label):
    """Ints, bools and strings equal; floats (and float arrays, NaN where
    the other is NaN) at ``RTOL``."""
    if isinstance(want, (bool, int, str, np.bool_)) and not isinstance(
            want, float):
        assert got == want, label
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=RTOL,
                                   atol=0, equal_nan=True, err_msg=label)


@pytest.mark.parametrize("name", SIM_SCRIPTS)
def test_script_imports_no_jax_repro_or_benchmarks(name):
    roots = torch_examples.imported_roots(name)
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots
    assert "repro_torch" in roots


@pytest.mark.parametrize("name", SIM_SCRIPTS)
@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_script_defaults_to_cuda_and_raises_without_a_card(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_examples.load(name).main([])


def test_quickstart_rows_equal_reference():
    qs = torch_examples.load("torch_quickstart")
    got = qs.simulate(CPU)
    res = RefExperiment(
        ref_get_scenario("paper-fabric", n_each=5),
        [("SDN", RefPolicyConfig(routing=ROUTE_SDN, job_concurrency=2)),
         ("legacy", RefPolicyConfig(routing=ROUTE_LEGACY,
                                    job_concurrency=2))]).run()
    want = res.rows()
    assert [r["policy"] for r in got["rows"]] == ["SDN", "legacy"]
    assert len(got["rows"]) == len(want) == 2
    for g, w in zip(got["rows"], want):
        assert g.keys() == w.keys()
        for k in w:
            _close(g[k], w[k], f"{w['policy']}/{k}")
        assert not g["stalled"]
    tr = res.job_report()["transmission_time"][0]
    _close(got["transmission"], np.nanmean(tr, axis=1), "transmission")


def _ref_pair(seed, split, conc):
    """The reference's fig11-13 pair: both routing modes in one batch on
    ``paper_setup(seed, split)``."""
    res = RefExperiment(
        scenarios=ref_paper_setup(seed=seed, split=split),
        policies=[(name, RefPolicyConfig(routing=routing,
                                         job_concurrency=conc, seed=seed))
                  for name, routing in (("sdn", ROUTE_SDN),
                                        ("legacy", ROUTE_LEGACY))]).run()
    return {name: res.summary(0, pi)
            for pi, name in enumerate(res.policy_names)}


def test_sdn_vs_legacy_quick_pair_equals_reference():
    svl = torch_examples.load("torch_sdn_vs_legacy")
    got = svl.usecase(True, CPU)
    assert [(r["seed"], r["split"], r["conc"]) for r in got["grid"]] \
        == [(0, 2, 2)]
    want = _ref_pair(0, 2, 2)
    rs, rl = want["sdn"], want["legacy"]

    def delta(a, b):
        return float(100.0 * (b - a) / b)
    deltas = {
        "transmission": delta(np.nanmean(rs["transmission_time"]),
                              np.nanmean(rl["transmission_time"])),
        "completion": delta(np.nanmean(rs["completion_measured"]),
                            np.nanmean(rl["completion_measured"])),
        "energy": delta(float(rs["total_energy_j"]),
                        float(rl["total_energy_j"]))}
    for k, v in deltas.items():
        _close(got["best_match_pct"][k], v, k)
        assert got["best_match_pct"][k] > 0, k
    assert got["qualitative_claim_reproduced"] is True
    fd = got["fig_data"]
    for lane, r in (("sdn", rs), ("legacy", rl)):
        for key, ref_key in (("transmission", "transmission_time"),
                             ("completion", "completion_measured"),
                             ("map_exec", "map_exec_time"),
                             ("reduce_exec", "reduce_exec_time")):
            assert len(fd[f"{lane}_{key}"]) == len(r[ref_key]) == 15
            _close(fd[f"{lane}_{key}"], r[ref_key], f"{lane}_{key}")
        _close(fd[f"{lane}_energy"], [r["host_energy_j"],
                                      r["switch_energy_j"]],
               f"{lane}_energy")
        assert not bool(r["stalled"])


def test_policy_sweep_lanes_equal_reference():
    ps = torch_examples.load("torch_policy_sweep")
    got = ps.sweep(16, CPU)
    combos = list(itertools.product(
        (ROUTE_SDN, ROUTE_LEGACY), (TRAFFIC_FAIRSHARE, TRAFFIC_WATERFILL),
        (PLACE_LEAST_USED, PLACE_RANDOM), (JOBSEL_FCFS, JOBSEL_SJF)))
    assert got["rows"] == [c + (0,) for c in combos]
    res = RefExperiment(
        scenarios=ref_paper_setup(seed=0, split=2),
        policies=[RefPolicyConfig(routing=r, traffic=t, placement=p,
                                  job_selection=j, job_concurrency=2, seed=0)
                  for r, t, p, j in combos]).run()
    want_ct = np.nanmean(res.job_report()["completion_measured"][0], axis=1)
    want_en = res.energy_report()["total_energy_j"][0]
    assert got["mean_ct"].shape == got["energy_j"].shape == (16,)
    _close(got["mean_ct"], want_ct, "mean completion")
    _close(got["energy_j"], want_en, "energy")
    assert np.isfinite(got["mean_ct"]).all()


def test_scenario_zoo_equals_reference():
    zoo = torch_examples.load("torch_scenario_zoo")
    names = ["paper-fabric", "fat-tree"]
    built = zoo.diversity(names, CPU)
    rows = zoo.race([(n, s) for n, s, _ in built], CPU)
    scens = []
    for name, (pname, _, div) in zip(names, built):
        sc = ref_get_scenario(name)
        setup = sc.build()
        topo = setup.cluster.topo
        nc = np.asarray(setup.route_table.n_cand).reshape(topo.n_nodes,
                                                          topo.n_nodes)
        off = nc[:topo.n_hosts, :topo.n_hosts][
            ~np.eye(topo.n_hosts, dtype=bool)]
        assert pname == sc.name
        assert (div["min"], div["max"]) == (int(off.min()), int(off.max()))
        assert div["mean"] == float(off.mean())
        scens.append((sc.name, setup))
    want = RefExperiment(
        scenarios=scens,
        policies=[("sdn", RefPolicyConfig(routing=ROUTE_SDN,
                                          job_concurrency=2)),
                  ("legacy", RefPolicyConfig(routing=ROUTE_LEGACY,
                                             job_concurrency=2))]
    ).run().rows()
    assert [(r["scenario"], r["policy"]) for r in rows] \
        == [(r["scenario"], r["policy"]) for r in want]
    for g, w in zip(rows, want):
        for k in ("mean_completion_s", "mean_transmission_s", "energy_kwh",
                  "makespan_s", "stalled", "steps"):
            _close(g[k], w[k], f"{w['scenario']}/{w['policy']}/{k}")
