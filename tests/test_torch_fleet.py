"""The port's fleet engine (``repro_torch.api.fleet``, DESIGN.md §9)
against its own serial run and the reference's: every case of
tests/test_fleet.py re-run on the port (the sharded case becomes "more
than one device without a group is capped at one"; the lanes spread over
ranks in tests/test_torch_fleet_mesh.py; the slow leaf-spine-xl case runs
on the card, ``chip_smoke.py`` phase 11(b)), the cohort
bookkeeping beside the reference's on the same inputs, and the port's
``run_fleet`` held against the reference's ``run_fleet`` on a refilling
grid with failures and on a chaos-plus-controller cohort with clone slots.

Every comparison is bitwise on the CPU (NaN == NaN): the chunk runs the
serial loop's body (``engine._advance``), so a lane stops at the very
state the serial run stops at."""
import numpy as np
import pytest
import torch

from repro.api import CohortSchedule as RefCohortSchedule
from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.api import StepPredictor as RefStepPredictor
from repro_torch.api import (CohortSchedule, Experiment, PolicyConfig,
                             StepPredictor, consts_build_count,
                             consts_cache_clear, run_fleet, runners)
from repro_torch.core.engine import (init_fleet_carry, make_consts,
                                     tree_select)
from repro_torch.scenarios import get_scenario, list_scenarios

# leaf-spine-xl runs for minutes on the CPU; its fleet path runs on the
# card (chip_smoke.py phase 11(b))
REGISTRY = [n for n in list_scenarios() if "xl" not in n]

# routing × placement: both routings, all three placements, one pair per
# static signature so the cohort grouping is exercised too
POLICIES = [
    {"routing": 0, "placement": 0},
    {"routing": 0, "placement": 2},
    {"routing": 1, "placement": 0},
    {"routing": 1, "placement": 1},
]
SEEDS = (0, 1, 2)
IMPLS = {"port": (CohortSchedule, StepPredictor),
         "ref": (RefCohortSchedule, RefStepPredictor)}


def assert_results_identical(a, b, context=""):
    """Leaf by leaf: equal dtype, shape and bits (NaN == NaN).  ``b`` may
    be the reference's Results (numpy/jax leaves)."""
    for name, la, lb in zip(a.states._fields, a.states, b.states):
        la = la.cpu().numpy()
        lb = lb.cpu().numpy() if isinstance(lb, torch.Tensor) \
            else np.asarray(lb)
        assert la.dtype == lb.dtype and la.shape == lb.shape, \
            f"{context}{name}: {la.dtype}{la.shape} != {lb.dtype}{lb.shape}"
        assert np.array_equal(la, lb, equal_nan=True), \
            f"{context}{name}: values differ"


def _both(scenarios, pols, seeds, **fleet):
    """The port's and the reference's ``run_fleet`` of one grid."""
    port = Experiment(scenarios, [PolicyConfig(**k) for k in pols],
                      seeds=seeds, device="cpu").run_fleet(
        return_stats=True, **fleet)
    ref = RefExperiment(scenarios, [RefPolicyConfig(**k) for k in pols],
                        seeds=seeds).run_fleet(return_stats=True, **fleet)
    return port, ref


# ---------------------------------------------------------------------------
# bit-identity to the serial run
# ---------------------------------------------------------------------------


def test_fleet_identical_across_registry():
    """One packed grid over every (non-xl) registry scenario, the failure,
    ctrl, chaos and streaming entries included, × routing/placement × 3
    seeds, drained by the fleet."""
    exp = Experiment(REGISTRY, POLICIES, seeds=SEEDS, device="cpu")
    serial = exp.run()
    fleet, stats = exp.run_fleet(width=5, chunk_steps=16, return_stats=True)
    assert_results_identical(serial, fleet, "registry grid: ")
    assert stats.sims == len(REGISTRY) * len(POLICIES) * len(SEEDS)
    # width 5 over 3-member cohorts: every cohort fits one wave
    assert stats.cohorts == len(REGISTRY) * len(POLICIES)
    assert fleet.states.time.shape == serial.states.time.shape


def test_fleet_identical_single_scenario_with_refill():
    """S == 1 (unpacked consts) with width << members, so lanes retire and
    refill mid-cohort."""
    exp = Experiment("paper-fabric", POLICIES[:1], seeds=range(9),
                     device="cpu")
    serial = exp.run()
    fleet, stats = exp.run_fleet(width=2, chunk_steps=8, return_stats=True)
    assert_results_identical(serial, fleet, "single-scenario: ")
    assert stats.refills > 0


def test_fleet_identical_length_divergent_bucket():
    """job_concurrency 1 serializes the workload (many more events) but is
    not a static field, so short and long sims share one cohort."""
    pols = [{"job_concurrency": c, "seed": s}
            for c in (1, 1_000_000) for s in SEEDS]
    exp = Experiment("leaf-spine", pols, device="cpu")
    serial = exp.run()
    steps = serial.states.steps[0].numpy()
    assert steps.max() >= steps.min() + 16, "bucket not length-divergent"
    fleet = exp.run_fleet(width=4, chunk_steps=8)
    assert_results_identical(serial, fleet, "divergent bucket: ")


def test_fleet_devices_capped_without_group():
    """Without a process group the fleet runs on this process alone:
    ``devices=1`` is the plain fleet, and more is capped at the world of
    one, as the reference caps at ``jax.local_device_count()`` (the lanes
    spread over ranks in tests/test_torch_fleet_mesh.py)."""
    exp = Experiment("paper-fabric", POLICIES, seeds=SEEDS, device="cpu")
    serial = exp.run()
    for devices in (1, 2):
        fleet, stats = exp.run_fleet(width=8, chunk_steps=16,
                                     devices=devices, return_stats=True)
        assert_results_identical(serial, fleet, f"devices={devices}: ")
        assert stats.devices == 1


# ---------------------------------------------------------------------------
# against the reference's run_fleet
# ---------------------------------------------------------------------------


def test_fleet_equals_reference_with_failures_and_refills():
    """Both failure entries packed, SDN and legacy × 3 seeds, width 2: the
    cohorts retire and refill under live outage schedules."""
    (port, pst), (ref, rst) = _both(
        ["paper-fabric-failures", "leaf-spine-failures"],
        [{"routing": 1, "job_concurrency": 2},
         {"routing": 0, "placement": 1, "job_concurrency": 2}],
        (0, 1, 2), width=2, chunk_steps=8)
    assert_results_identical(port, ref, "failures fleet vs reference: ")
    assert pst.refills == rst.refills > 0
    assert (pst.sims, pst.cohorts, pst.chunks) == \
        (rst.sims, rst.cohorts, rst.chunks)
    assert bool(port.states.task_restarts.sum() > 0)


def test_fleet_equals_reference_chaos_ctrl_with_clones():
    """paper-fabric-chaos (outages, gray windows, a failing-over
    controller, 2 clone slots a job) under speculating SDN reactive, SDN
    proactive and legacy lanes × 2 seeds, width 2 (refills)."""
    (port, pst), (ref, rst) = _both(
        "paper-fabric-chaos",
        [{"routing": 1, "speculation": 1, "job_concurrency": 2},
         {"routing": 1, "speculation": 1, "install_mode": 1,
          "job_concurrency": 2},
         {"routing": 0, "speculation": 1, "job_concurrency": 2}],
        (0, 1), width=2, chunk_steps=8)
    assert port.meta.spec_slots > 0 and port.meta.has_ctrl
    assert_results_identical(port, ref, "chaos fleet vs reference: ")
    assert pst.refills == rst.refills > 0
    assert bool(port.states.spec_launches.sum() > 0)


# ---------------------------------------------------------------------------
# the carry helpers
# ---------------------------------------------------------------------------


def test_init_fleet_carry_and_tree_select():
    setup = get_scenario("paper-fabric").build("cpu")
    consts, meta = make_consts(setup, "cpu")
    s, cache, nc, done = init_fleet_carry(consts, meta, 3)
    assert all(leaf.shape[0] == 3 for leaf in s)
    assert cache["pair"].shape == (3, consts.pkt_job.shape[0])
    assert nc.shape == (3, meta.n_links) and not bool(nc.any())
    assert done.tolist() == [False] * 3
    moved = s._replace(time=s.time + 1.0)
    mask = torch.tensor([True, False, True])
    out = tree_select(mask, (s, cache, nc, done), (moved, cache, nc, done))
    assert out[0].time.tolist() == [0.0, 1.0, 0.0]
    assert type(out[0]) is type(s) and isinstance(out[1], dict)


# ---------------------------------------------------------------------------
# cohort bookkeeping, each case on the port and on the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", list(IMPLS))
def test_cohort_schedule_retire_refill_and_pads(impl):
    sched = IMPLS[impl][0](["a", "b", "c", "d", "e"], width=3)
    assert sched.lane == ["a", "b", "c"]
    assert not sched.pad_mask().any()
    assert sched.active
    retire, refill = sched.step(np.array([False, True, False]))
    assert retire == [(1, "b")]
    assert refill.tolist() == [False, True, False]
    assert sched.lane == ["a", "d", "c"]
    retire, refill = sched.step(np.array([True, True, True]))
    assert sorted(m for _, m in retire) == ["a", "c", "d"]
    assert refill.sum() == 1 and sched.lane.count(None) == 2
    assert sched.pad_mask().sum() == 2
    assert sched.active
    retire, refill = sched.step(np.array([True, True, True]))
    assert [m for _, m in retire] == ["e"] and not refill.any()
    assert not sched.active
    assert sorted(m for _, m in sched.retired) == list("abcde")


@pytest.mark.parametrize("impl", list(IMPLS))
def test_cohort_schedule_width_wider_than_members(impl):
    sched = IMPLS[impl][0](["a"], width=4)
    assert sched.pad_mask().tolist() == [False, True, True, True]
    retire, refill = sched.step(np.array([True] * 4))
    assert retire == [(0, "a")] and not refill.any()
    assert not sched.active


@pytest.mark.parametrize("impl", list(IMPLS))
def test_step_predictor_orders_by_observation(impl):
    pred = IMPLS[impl][1]()
    assert pred.predict("m1", "g", 10, 20) == pred.predict("m2", "g", 10, 20)
    pred.observe("m1", 100.0)
    pred.observe("m2", 10.0)
    assert pred.predict("m2", "g", 10, 20) < pred.predict("m1", "g", 10, 20)
    pred.observe("m2", 100.0)
    assert 10.0 < pred.predict("m2", "g", 10, 20) < 100.0


def test_schedules_agree_with_reference():
    """One random done-flag sequence through both CohortSchedules and both
    StepPredictors: the same retires, refills, lanes and estimates."""
    rng = np.random.default_rng(0)
    port, ref = CohortSchedule(list(range(11)), 4), \
        RefCohortSchedule(list(range(11)), 4)
    pp, rp = StepPredictor(), RefStepPredictor()
    while port.active:
        done = rng.random(4) < 0.4
        a, b = port.step(done), ref.step(done)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
        assert port.lane == ref.lane
        for _, m in a[0]:
            n = float(rng.integers(10, 200))
            pp.observe(m, n), rp.observe(m, n)
            pp.observe("g", n), rp.observe("g", n)
    assert not ref.active
    for m in range(12):
        assert pp.predict(m, "g", 5, 9) == rp.predict(m, "g", 5, 9)


def test_fleet_bucket_order_does_not_change_results():
    """A calibrated predictor (the second fleet) reproduces the cold-start
    results bit for bit."""
    exp = Experiment("paper-fabric", POLICIES[:1], seeds=range(6),
                     device="cpu")
    pred = StepPredictor()
    first = run_fleet(exp, width=2, chunk_steps=8, predictor=pred)
    second = run_fleet(exp, width=2, chunk_steps=8, predictor=pred)
    assert_results_identical(first, second, "calibrated reorder: ")


# ---------------------------------------------------------------------------
# keyed caches
# ---------------------------------------------------------------------------


def test_consts_built_once_per_scenario_set():
    consts_cache_clear()
    names = ["paper-fabric", "leaf-spine"]
    e1 = Experiment(names, POLICIES[:1], device="cpu")
    e1.build()
    e1.build()                                  # instance memo
    assert consts_build_count() == 1
    Experiment(names, POLICIES[:2], device="cpu").build()
    assert consts_build_count() == 1            # cross-Experiment cache
    Experiment("paper-fabric", device="cpu").build()
    assert consts_build_count() == 2            # different key -> new build
    # a consts-cache hit also hits the runner cache, for run and run_fleet
    runners.cache_clear()
    Experiment(names, POLICIES[:1], device="cpu").run()
    Experiment(names, POLICIES[:1], device="cpu").run_fleet(width=2)
    n = runners.cache_size()
    Experiment(names, POLICIES[:1], device="cpu").run()
    Experiment(names, POLICIES[:1], device="cpu").run_fleet(width=2)
    assert runners.cache_size() == n


def test_consts_cache_skips_failure_crosses():
    from repro_torch.scenarios.failures import failure_injector
    consts_cache_clear()
    for _ in range(2):
        Experiment("paper-fabric", device="cpu",
                   failures=failure_injector(host_rate=0.05)).build()
    assert consts_build_count() == 2
