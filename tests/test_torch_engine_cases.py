"""The tests/test_engine.py cases re-run on the port (closed forms,
conservation and clock, the energy bound, SDN beats legacy, water-fill not
slower, the stall on a disconnected fabric), the tests/invariants.py
checkers on port states, and leaf-spine-xl (jobs cut) against the
reference."""
import numpy as np
import pytest
import torch

from invariants import check_all
from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.scenarios import get_scenario as ref_get_scenario
from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core import (ROUTE_LEGACY, ROUTE_SDN, TRAFFIC_WATERFILL,
                              paper_setup, summarize)
from repro_torch.core.engine import make_consts
from repro_torch.core.flows import Flow, flows_setup
from repro_torch.core.mapreduce import DONE
from repro_torch.core.topology import Topology, torus_2d
from repro_torch.scenarios import get_scenario
from test_torch_engine import assert_states_match


def simulate(setup, pol=None):
    """One replica on the CPU: the unbatched final SimState."""
    return Experiment(setup, pol, device="cpu").run().state()


@pytest.fixture(scope="module")
def two_hosts():
    return torus_2d(2, 1, bw=1e9)


@pytest.fixture(scope="module")
def paper():
    return paper_setup(seed=0, device="cpu")


def t(topo, flows, **pol):
    s = simulate(flows_setup(topo, flows, device="cpu"), PolicyConfig(**pol))
    assert not bool(s.stalled)
    return float(s.time)


@pytest.mark.parametrize("flows,want,rel", [
    ([Flow(0, 1, 8.0)], 8.0, 1e-4),                           # one flow
    ([Flow(0, 1, 8.0)] * 2, 16.0, 1e-3),                      # shared link
    ([Flow(0, 1, 8.0), Flow(1, 0, 8.0)], 8.0, 1e-3),          # full duplex
    ([Flow(0, 1, 8.0, round=0), Flow(0, 1, 8.0, round=1)], 16.0, 1e-3),
    # 2 Gb and 6 Gb share 1 Gbps until t=4, then 4 Gb at full rate
    ([Flow(0, 1, 2.0), Flow(0, 1, 6.0)], 8.0, 1e-3),
], ids=["single", "share", "duplex", "rounds", "release"])
def test_closed_forms(two_hosts, flows, want, rel):
    assert t(two_hosts, flows) == pytest.approx(want, rel=rel)


def test_conservation_and_clock(paper):
    s = simulate(paper, PolicyConfig())
    assert not bool(s.stalled)
    valid_p = paper.pkt_valid
    assert np.all(s.pkt_state.numpy()[valid_p] == DONE)
    assert np.all(s.pkt_rem.numpy()[valid_p] <=
                  paper.pkt_bits[valid_p] * 1e-5 + 1.0)
    assert np.all(s.task_state.numpy()[paper.task_valid] == DONE)
    dur = (s.pkt_finish - s.pkt_start).numpy()[valid_p]
    assert np.all(dur >= -1e-5)
    assert float(s.time) > 0


def test_energy_positive_and_bounded(paper):
    s = simulate(paper, PolicyConfig())
    host_e, sw_e = s.host_energy.numpy(), s.switch_energy.numpy()
    assert np.all(host_e >= 0) and np.all(sw_e >= 0)
    T = float(s.time)
    assert np.all(host_e <= 250.0 * T + 1)
    assert np.all(sw_e <= (100.0 + 64 * 10.0) * T + 1)


def test_sdn_beats_legacy_on_paper_usecase(paper):
    """The paper's qualitative claim (§5.3): SDN >= legacy on all three."""
    rs = summarize(paper, simulate(paper, PolicyConfig(
        routing=ROUTE_SDN, job_concurrency=2)))
    rl = summarize(paper, simulate(paper, PolicyConfig(
        routing=ROUTE_LEGACY, job_concurrency=2)))
    assert np.nanmean(rs["transmission_time"]) < \
        np.nanmean(rl["transmission_time"])
    assert np.nanmean(rs["completion_measured"]) < \
        np.nanmean(rl["completion_measured"])
    assert rs["total_energy_j"] < rl["total_energy_j"]


def test_waterfill_not_slower(paper):
    base = summarize(paper, simulate(paper, PolicyConfig()))
    wf = summarize(paper, simulate(paper, PolicyConfig(
        traffic=TRAFFIC_WATERFILL)))
    assert wf["makespan_s"] <= base["makespan_s"] * 1.05


def test_stall_detected_on_disconnected():
    iso = Topology(n_hosts=4, n_switches=0, n_storage=0,
                   link_src=np.asarray([0, 1, 2, 3], np.int32),
                   link_dst=np.asarray([1, 0, 3, 2], np.int32),
                   link_bw=np.full(4, 1e9, np.float32))
    s = simulate(flows_setup(iso, [Flow(0, 2, 1.0)], device="cpu"))
    assert bool(s.stalled)


@pytest.mark.parametrize("scenario", ["paper-fabric", "leaf-spine",
                                      "fat-tree", "canonical-tree"])
def test_invariants_hold_on_port_states(scenario):
    setup = get_scenario(scenario).build("cpu")
    consts, meta = make_consts(setup, device="cpu")
    pols = [PolicyConfig(routing=r, traffic=tr, placement=p)
            for r in (ROUTE_SDN, ROUTE_LEGACY) for tr in (0, 1)
            for p in (0, 1, 2)]
    res = Experiment(setup, pols, device="cpu").run()
    for w, name in enumerate(res.policy_names):
        check_all(consts, meta, res.state(0, w), label=f"{scenario}/{name}")


def test_leaf_spine_xl_cut_equals_reference():
    """The xl fabric at full width (128 hosts, 24 switches, K=8) with the
    job mix cut to 24 jobs, SDN and least-used under job_concurrency=4."""
    ref_setup = ref_get_scenario("leaf-spine-xl", n_jobs=24).build()
    ref = RefExperiment(ref_setup, RefPolicyConfig(job_concurrency=4)).run()
    port = Experiment(get_scenario("leaf-spine-xl", n_jobs=24).build("cpu"),
                      PolicyConfig(job_concurrency=4), device="cpu").run()
    ref_states = type(ref.states)(*(np.asarray(leaf) for leaf in ref.states))
    assert not bool(ref_states.stalled[0, 0])
    assert int(ref_states.steps[0, 0]) > 100
    assert_states_match(port.states, ref_states, "leaf-spine-xl/24")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment("paper-fabric").run()



def test_make_simulator_equals_experiment(paper):
    """The low-level runner on one config's 0-d policy arrays (broadcast to
    one lane) gives the Experiment front door's state."""
    from repro_torch.core import as_policy_arrays, make_simulator
    from repro_torch.core.engine import lane_policies
    pol = PolicyConfig(routing=ROUTE_LEGACY, placement=2, seed=3)
    s = make_simulator(paper, device="cpu")(
        lane_policies(as_policy_arrays(pol)))
    want = simulate(paper, pol)
    for name, a, b in zip(want._fields, s, want):
        assert a.shape[0] == 1, name
        np.testing.assert_array_equal(a[0].numpy(), b.numpy(), err_msg=name)
