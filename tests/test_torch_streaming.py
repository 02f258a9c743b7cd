"""The port's streaming ring (``repro_torch.core.streaming``,
``repro_torch.api.stream``, DESIGN.md §11) against the reference: every
case of tests/test_streaming.py re-run on the port (the slow 100k-job case
runs on the card instead, ``chip_smoke.py`` phase 11(d)), the ring's
lowering (``slot_arrays``, ``ring_setup``) leaf by leaf, a refilling
trace's job rows, boundary samples, ``StreamStats``, final states and
chaos counters against the reference's ``run_stream``, and ``make_refill``
on states with live clones against the reference's.

Every comparison is bitwise on the CPU (NaN == NaN)."""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from invariants import check_all, check_stream
from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.core import streaming as ref_streaming
from repro.scenarios import get_scenario as ref_get_scenario
from repro.scenarios import arrivals as ref_arrivals
from repro.scenarios.registry import stream_arrivals as ref_stream_arrivals
from repro.scenarios.workloads import JobTemplate as RefJobTemplate
from repro_torch.api import Experiment, PolicyConfig
from repro_torch.api import stream as port_stream
from repro_torch.core import streaming
from repro_torch.core.engine import init_fleet_carry, make_consts
from repro_torch.core.policies import (PLACE_ROUND_ROBIN, ROUTE_LEGACY,
                                       ROUTE_SDN, TRAFFIC_WATERFILL)
from repro_torch.core.streaming import RingSpec, ring_setup
from repro_torch.scenarios import get_scenario
from repro_torch.scenarios.arrivals import (PoissonArrivals, ServiceClass,
                                            TraceArrivals)
from repro_torch.scenarios.registry import stream_arrivals
from repro_torch.scenarios.workloads import JobTemplate
from test_torch_ctrlplane import as_numpy

POLICY_KW = [
    ("sdn", dict(routing=ROUTE_SDN, job_concurrency=2)),
    ("legacy", dict(routing=ROUTE_LEGACY, job_concurrency=2,
                    placement=PLACE_ROUND_ROBIN)),
    ("wfill", dict(routing=ROUTE_SDN, traffic=TRAFFIC_WATERFILL, seed=1)),
]
POLICIES = [(n, PolicyConfig(**k)) for n, k in POLICY_KW]
# a second lane in the sdn cohort: the same static signature (routing,
# traffic, placement) as "sdn" but another admission width and seed, so the
# two lanes retire and refill ring slots at different times and the
# streamed consts carry a lane axis of width 2
SDN_WIDE = ("sdn-c4", dict(routing=ROUTE_SDN, job_concurrency=4, seed=1))
REF_POLICIES = [(n, RefPolicyConfig(**k)) for n, k in POLICY_KW]


def assert_state_bitwise(a, b, label=""):
    """One unbatched SimState against another (port tensors, or the
    reference's numpy/jax leaves): dtype, shape and bits (NaN == NaN)."""
    for name, x, y in zip(a._fields, a, b):
        x = x.cpu().numpy()
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{label}: {name}"
        assert np.array_equal(x, y, equal_nan=True), f"{label}: {name}"


def assert_stream_equal(port, ref, label=""):
    """Two StreamResults: stats, job rows, samples, chaos counters and (when
    kept) final states and consts, bit for bit."""
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.policy_names == ref.policy_names
    for pi in range(ref.n_policies):
        for k, v in ref.jobs[pi].items():
            assert port.jobs[pi][k].dtype == v.dtype, f"{label}: {k}"
            assert np.array_equal(port.jobs[pi][k], v), f"{label}: jobs.{k}"
        assert np.array_equal(port.samples[pi], ref.samples[pi]), \
            f"{label}: samples"
        assert port.chaos[pi] == ref.chaos[pi], f"{label}: chaos"
        if ref.final_states is not None:
            assert_state_bitwise(port.final_states[pi], ref.final_states[pi],
                                 f"{label}/{pi}")
            for f in streaming.STREAM_FIELDS:
                assert np.array_equal(
                    getattr(port.final_consts[pi], f).numpy(),
                    np.asarray(getattr(ref.final_consts[pi], f))), f


# ---------------------------------------------------------------------------
# tests/test_streaming.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scen,seed", [
    ("leaf-spine", 0), ("leaf-spine", 1),
    ("paper-fabric-ctrl", 0), ("leaf-spine-failures", 1),
])
def test_finite_trace_bit_identity(scen, seed):
    """A trace that fits the slots (zero refills) reproduces
    ``Experiment.run`` on the same ring setup bit for bit, for every
    policy."""
    kw = dict(split=1) if scen.startswith("paper") else dict(n_jobs=3)
    setup = get_scenario(scen, seed=seed, **kw).build("cpu")
    horizon = 1e9
    arrivals = TraceArrivals(jobs=tuple(setup.jobs))
    jobs = [a.job for a in arrivals.events(horizon)]   # submit-time order
    spec = RingSpec.for_jobs(jobs, slots=len(jobs))

    exp = Experiment((scen, setup), POLICIES, device="cpu")
    res = exp.run_stream(arrivals, horizon, slots=len(jobs),
                         return_states=True)
    assert res.stats.refills == 0          # the trace fit the ring

    rs = ring_setup(jobs, setup.cluster, spec, route_table=setup.route_table,
                    failures=setup.failures, ctrl=setup.ctrl)
    ref = Experiment(("ring", rs), POLICIES, device="cpu").run()
    for pi, (pname, _) in enumerate(POLICIES):
        assert_state_bitwise(ref.state(0, pi), res.final_states[pi],
                             f"{scen}/seed{seed}/{pname}")


def test_refill_conserves_arrivals():
    """A trace LONGER than the ring recycles slots; every arrival is loaded
    and retired exactly once per lane and sojourns are sane."""
    setup = get_scenario("leaf-spine", n_jobs=2).build("cpu")
    times = tuple(3.0 * i for i in range(12))
    arrivals = TraceArrivals(
        times=times,
        classes=(ServiceClass("only", slo_s=500.0,
                              template=JobTemplate(n_map=2, n_reduce=1)),))
    exp = Experiment(("leaf-spine", setup), POLICIES[:2], device="cpu")
    res = exp.run_stream(arrivals, horizon=40.0, slots=4, chunk_steps=64)
    assert res.stats.trace_len == sum(1 for t in times if t < 40.0)
    assert res.stats.refills > 0
    check_stream(res, label="refill")
    for pi in range(res.n_policies):
        j = res.jobs[pi]
        assert np.all(j["sojourn"] > 0)
        assert np.all(j["t_admit"] >= j["t_arr"] - 1e-4)


def test_windowed_metrics_shape_and_nan_masking():
    """Windows cover every completion; empty windows are NaN (not 0) for
    percentile metrics and SLO attainment, 0 for counts."""
    setup = get_scenario("leaf-spine", n_jobs=2).build("cpu")
    arrivals = PoissonArrivals(
        rate=0.12, seed=4,
        classes=(ServiceClass("a", slo_s=100.0, share=0.5),
                 ServiceClass("b", slo_s=30.0, share=0.5, weight=1.0)))
    exp = Experiment(("leaf-spine", setup), POLICIES[:1], device="cpu")
    res = exp.run_stream(arrivals, horizon=150.0, warmup=30.0, window=25.0,
                         slots=4)
    wd = res.windows(0)
    n_w = wd["t0"].size
    assert wd["slo_attainment"].shape == (2, n_w)
    assert wd["t1"][-1] >= max(res.horizon,
                               float(res.jobs[0]["t_done"].max()))
    empty = wd["n_done"] == 0
    assert np.all(np.isnan(wd["p99_sojourn_s"][empty]))
    assert np.all(wd["throughput_jobs_s"][empty] == 0.0)
    done = wd["n_done"] > 0
    assert np.all(wd["p50_sojourn_s"][done] <= wd["p99_sojourn_s"][done])
    att = wd["slo_attainment"]
    assert np.all((att[np.isfinite(att)] >= 0) & (att[np.isfinite(att)] <= 1))
    sm = res.summary(0)
    n_after = int((res.jobs[0]["t_done"] >= 30.0).sum())
    assert sm["jobs_done"] == n_after
    assert set(sm["classes"]) == {"a", "b"}
    rows = [r for r in res.rows() if r["policy"] == res.policy_names[0]]
    assert len(rows) == n_w and "slo_a" in rows[0] and "slo_b" in rows[0]


def test_ring_spec_rejects_oversize_job():
    setup = get_scenario("leaf-spine", n_jobs=2).build("cpu")
    big = TraceArrivals(
        times=(1.0,),
        classes=(ServiceClass("big",
                              template=JobTemplate(n_map=9, n_reduce=3)),))
    spec = RingSpec(slots=2, n_map_max=2, n_reduce_max=1)
    exp = Experiment(("leaf-spine", setup), POLICIES[:1], device="cpu")
    with pytest.raises(ValueError, match="slot geometry"):
        exp.run_stream(big, horizon=10.0, spec=spec)


# ---------------------------------------------------------------------------
# the ring's lowering against the reference
# ---------------------------------------------------------------------------


def _jobs(n, seed):
    """The first ``n`` jobs of ``stream_arrivals`` in both packages."""
    p = stream_arrivals(rate=0.1, seed=seed)
    r = ref_stream_arrivals(rate=0.1, seed=seed)
    pj, rj = [], []
    for a, b in zip(p.events(1e9), r.events(1e9)):
        pj.append(a.job)
        rj.append(b.job)
        if len(pj) == n:
            return pj, rj


@pytest.mark.parametrize("split", [1, 2])
def test_slot_arrays_equal_reference(split):
    pj, rj = _jobs(5, seed=3)
    spec = RingSpec.for_jobs(pj, slots=6, split=split)
    rspec = ref_streaming.RingSpec.for_jobs(rj, slots=6, split=split)
    assert (spec.tasks_per_slot, spec.pkts_per_slot) == \
        (rspec.tasks_per_slot, rspec.pkts_per_slot)
    for slot in range(6):
        job = pj[slot] if slot < 5 else None
        rjob = rj[slot] if slot < 5 else None
        a = streaming.slot_arrays(spec, slot, job)
        b = ref_streaming.slot_arrays(rspec, slot, rjob)
        assert a.keys() == b.keys() == set(streaming.STREAM_FIELDS)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.array_equal(a[k], b[k]), k


def test_ring_setup_and_consts_equal_reference():
    pj, rj = _jobs(4, seed=1)
    setup = get_scenario("leaf-spine", n_jobs=2).build("cpu")
    rsetup = ref_get_scenario("leaf-spine", n_jobs=2).build()
    spec = RingSpec.for_jobs(pj, slots=5, split=2)
    rspec = ref_streaming.RingSpec.for_jobs(rj, slots=5, split=2)
    a = ring_setup(pj, setup.cluster, spec, route_table=setup.route_table,
                   spec_slots=2)
    b = ref_streaming.ring_setup(rj, rsetup.cluster, rspec,
                                 route_table=rsetup.route_table,
                                 spec_slots=2)
    for f in dataclasses.fields(b):
        if f.name in ("cluster", "route_table", "jobs"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    consts, meta = make_consts(a, "cpu")
    host = streaming.host_stream_arrays(consts, 3)
    from repro.core.engine import make_consts as ref_make_consts
    rconsts, rmeta = ref_make_consts(b)
    rhost = ref_streaming.host_stream_arrays(rconsts, 3)
    streaming.load_slot(host, spec, 1, 4, pj[0])
    ref_streaming.load_slot(rhost, rspec, 1, 4, rj[0])
    streaming.load_slot(host, spec, 2, 0, None)
    ref_streaming.load_slot(rhost, rspec, 2, 0, None)
    for f in streaming.STREAM_FIELDS:
        assert host[f].dtype == rhost[f].dtype, f
        assert np.array_equal(host[f], rhost[f]), f
    with pytest.raises(ValueError, match="exceed"):
        ring_setup(pj, setup.cluster, RingSpec.for_jobs(pj, slots=3))


# ---------------------------------------------------------------------------
# run_stream against the reference's
# ---------------------------------------------------------------------------


def _both_streams(port_setup, ref_setup, arrivals_kw, run_kw,
                  kinds=("poisson",), pols=(*POLICY_KW, SDN_WIDE)):
    """The port's and the reference's run_stream of one scenario pair, and
    whether some cohort's lanes held different jobs in one ring generation
    (so the streamed consts' lane axis was really exercised)."""
    def arr(mod, tmpl):
        if "times" in arrivals_kw:
            return mod.TraceArrivals(
                times=arrivals_kw["times"],
                classes=(mod.ServiceClass(
                    "only", slo_s=500.0,
                    template=tmpl(n_map=2, n_reduce=1)),))
        return mod.PoissonArrivals(
            rate=arrivals_kw["rate"], seed=arrivals_kw["seed"],
            classes=(mod.ServiceClass("a", slo_s=100.0, share=0.6),
                     mod.ServiceClass("b", slo_s=40.0, share=0.4,
                                      weight=1.0,
                                      template=tmpl(n_map=2, n_reduce=1))))
    from repro_torch.scenarios import arrivals as port_arrivals
    upload, diverged = port_stream._upload, []

    def spy(consts0, host, dev):
        # did a cohort's first and last lanes hold different jobs when
        # this ring generation went up?
        diverged.append(any(bool((host[f][0] != host[f][-1]).any())
                            for f in streaming.STREAM_FIELDS))
        return upload(consts0, host, dev)

    with mock.patch.object(port_stream, "_upload", spy):
        port = Experiment(("s", port_setup), [(n, PolicyConfig(**k))
                                              for n, k in pols],
                          device="cpu").run_stream(
            arr(port_arrivals, JobTemplate), return_states=True, **run_kw)
    ref = RefExperiment(("s", ref_setup), [(n, RefPolicyConfig(**k))
                                           for n, k in pols]).run_stream(
        arr(ref_arrivals, RefJobTemplate), return_states=True, **run_kw)
    return port, ref, any(diverged)


def test_refilling_stream_equals_reference():
    """A Poisson trace of two classes through a 3-slot ring on leaf-spine
    under four policies in three cohorts, one of them two lanes wide
    (sdn and sdn-c4, whose lanes recycle slots at different times): every
    job row, boundary sample, ``StreamStats`` entry, final state and the
    consts of each lane's last ring generation equal the reference's."""
    port, ref, diverged = _both_streams(
        get_scenario("leaf-spine", n_jobs=2).build("cpu"),
        ref_get_scenario("leaf-spine", n_jobs=2).build(),
        dict(rate=0.1, seed=5),
        dict(horizon=120.0, slots=3, chunk_steps=16, warmup=20.0))
    assert port.stats.refills > 3 * 3
    assert (port.stats.lanes, port.stats.cohorts) == (4, 3) and diverged
    check_stream(port, label="port")
    assert_stream_equal(port, ref, "leaf-spine stream")
    for pi in range(port.n_policies):
        for k, v in ref.summary(pi).items():
            assert port.summary(pi)[k] == v or (
                isinstance(v, float) and np.isnan(v)), k


def test_failure_ctrl_stream_equals_reference():
    """paper-fabric-ctrl under a host crash, streamed with refills: the
    failure and controller terms through the per-lane ring."""
    from repro.core import host_crash as ref_host_crash
    from repro_torch.core import host_crash
    p0 = get_scenario("paper-fabric-ctrl", split=1).build("cpu")
    r0 = ref_get_scenario("paper-fabric-ctrl", split=1).build()
    topo = p0.cluster.topo
    p0 = dataclasses.replace(p0, failures=host_crash(
        topo.n_hosts, topo.n_links, host=2, at=15.0, recover_at=40.0))
    r0 = dataclasses.replace(r0, failures=ref_host_crash(
        topo.n_hosts, topo.n_links, host=2, at=15.0, recover_at=40.0))
    port, ref, diverged = _both_streams(p0, r0, dict(times=tuple(
        2.5 * i for i in range(10))), dict(horizon=30.0, slots=3,
                                            chunk_steps=24),
        pols=(*POLICY_KW[:2], SDN_WIDE))
    assert port.stats.refills > 0 and port.meta.has_failures
    assert port.stats.cohorts == 2 and diverged
    check_stream(port, label="port")
    assert_stream_equal(port, ref, "ctrl+failure stream")


def test_make_refill_with_live_clones_equals_reference():
    """``make_refill`` on a chaos ring whose lanes hold live clones: the
    cancelled clones give their VM load back, the refilled tasks' latch
    re-arms, the refilled entries reset and nothing else moves; equal to
    the reference's on the same inputs."""
    import jax.numpy as jnp
    from repro.core.engine import EngineConsts as RefEngineConsts
    from repro.core.engine import SimState as RefSimState
    setup = get_scenario("leaf-spine-chaos", n_jobs=3).build("cpu")
    consts, meta = make_consts(setup, "cpu")
    W = 2
    s, cache, nc, _ = init_fleet_carry(consts, meta, W)
    rng = np.random.default_rng(0)
    n_j, n_t = s.job_admitted.shape[1], s.task_state.shape[1]
    n_p, n_v = s.pkt_state.shape[1], s.vm_load.shape[1]
    n_s = s.spec_of.shape[1]
    spec_of = np.where(rng.random((W, n_s)) < 0.5,
                       rng.integers(0, n_t, (W, n_s)), -1).astype(np.int32)
    spec_of[:, 0] = 1                  # job 0's first clone slot is live
    spec_vm = np.where(spec_of >= 0, rng.integers(0, n_v, (W, n_s)),
                       -1).astype(np.int32)
    s = s._replace(
        spec_of=torch.from_numpy(spec_of), spec_vm=torch.from_numpy(spec_vm),
        spec_rem=torch.from_numpy(rng.random((W, n_s)).astype(np.float32)),
        spec_start=torch.from_numpy(rng.random((W, n_s)).astype(np.float32)),
        task_cloned=torch.from_numpy(rng.random((W, n_t)) < 0.5),
        vm_load=torch.from_numpy(rng.integers(3, 9, (W, n_v))
                                 .astype(np.int32)),
        job_admitted=torch.ones((W, n_j), dtype=torch.bool),
        steps=torch.tensor([17, 5], dtype=torch.int32),
        task_state=torch.full((W, n_t), 2, dtype=torch.int32),
        pkt_state=torch.full((W, n_p), 2, dtype=torch.int32),
        task_rem=torch.zeros((W, n_t)), pkt_rem=torch.zeros((W, n_p)))
    masks = [rng.random((W, n)) < 0.4 for n in (n_j, n_t, n_p)]
    masks[0][:, 0] = True              # job 0's slot is recycled
    lane_m = np.array([True, False])
    lanes_c = consts._replace(**{
        f: getattr(consts, f).expand(W, -1).clone()
        for f in streaming.STREAM_FIELDS})
    port_s, _, _, port_done = streaming.make_refill(meta)(
        lanes_c, (s, cache, nc, torch.zeros(W, dtype=torch.bool)),
        *(torch.from_numpy(m) for m in (*masks, lane_m)))

    from repro.core.engine import make_consts as ref_make_consts
    rconsts, rmeta = ref_make_consts(
        ref_get_scenario("leaf-spine-chaos", n_jobs=3).build())
    rconsts = rconsts._replace(**{
        f: jnp.asarray(np.asarray(getattr(lanes_c, f)))
        for f in streaming.STREAM_FIELDS})
    rs = RefSimState(*(jnp.asarray(a.numpy()) for a in s))
    ref_s, _, ref_done = ref_streaming.make_refill(rmeta)(
        rconsts, (rs, {}, jnp.zeros(W, bool)),
        *(jnp.asarray(m) for m in (*masks, lane_m)))
    assert_state_bitwise(port_s, ref_s, "refill")
    assert port_done.tolist() == np.asarray(ref_done).tolist()
    assert port_s.steps.tolist() == [0, 5]
    assert bool((port_s.vm_load < s.vm_load).any())
    assert isinstance(rconsts, RefEngineConsts)


# ---------------------------------------------------------------------------
# the registry's streaming entry and the streaming invariants
# ---------------------------------------------------------------------------


def test_stream_registry_entry_equals_reference():
    """``leaf-spine-stream``'s finite preview builds the reference's setup
    and runs to the reference's states; ``stream_arrivals`` draws the
    reference's trace."""
    p = Experiment("leaf-spine-stream", [p for _, p in POLICIES[:2]],
                   device="cpu")
    r = RefExperiment("leaf-spine-stream", [p for _, p in REF_POLICIES[:2]])
    assert p.scenario_names == r.scenario_names
    for f in ("job_release", "task_mi", "pkt_bits", "pkt_src_task"):
        assert np.array_equal(getattr(p.scenarios[0][1], f),
                              getattr(r.scenarios[0][1], f)), f
    pr, rr = p.run(), r.run()
    for pi in range(2):
        assert_state_bitwise(pr.state(0, pi),
                             type(rr.states)(*(a[0, pi]
                                               for a in rr.states)),
                             "leaf-spine-stream")


def test_streaming_registry_invariants():
    """The streaming engine over registry scenarios: the streaming ledger
    (check_stream) and every per-state invariant, slot conservation
    included, on numpy copies of the drained final states against the
    consts of each lane's LAST ring generation."""
    for scen, arrivals, horizon in [
            ("leaf-spine", stream_arrivals(rate=0.08, seed=2), 120.0),
            ("canonical-tree", stream_arrivals(rate=0.06, seed=3), 150.0)]:
        exp = Experiment(get_scenario(scen, n_jobs=2),
                         [p for _, p in POLICIES[:2]], device="cpu")
        res = exp.run_stream(arrivals, horizon, slots=3, chunk_steps=48,
                             return_states=True)
        assert res.stats.refills > 0     # the ring actually recycled
        check_stream(res, label=scen)
        for pi in range(res.n_policies):
            check_all(as_numpy(res.final_consts[pi]), res.meta,
                      as_numpy(res.final_states[pi]),
                      label=f"{scen}/{res.policy_names[pi]}")
