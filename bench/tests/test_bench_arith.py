"""The benchmark's arithmetic: the metric readers over spans, the idle
share from an interval union, the APSP bound and the relative gap."""
import math

import numpy as np
import pytest

from bench import check, peaks, spec
from bench import trace as tr
from bench.harness import Run


class FakeRec(tr.Recorder):
    def __init__(self, spans):
        self.spans = [(n, 0.0, d, a) for n, d, a in spans]


def run_of(spans=(), counters=None, trace=None):
    return Run(cell=None, rec=FakeRec(spans), counters=counters or {},
               trace=trace)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert tr.union_length(iv) == 26
    assert [list(x) for x in tr.gaps(iv, 0, 50)] == [[15, 31], [20, 50]]
    assert [list(x) for x in tr.gaps([], 3, 7)] == [[3], [7]]
    assert tr.union_length([]) == 0


def events(*evs):
    return tuple(map(list, zip(*evs))) if evs else ([], [], [])


def test_breakdown_names_host_activity():
    dev = events((0, 10, "k1"), (30, 40, "k2"), (50, 55, "k1"))
    host = events((25, 35, "cudaStreamSynchronize"), (12, 22, "cudaLaunch"))
    spans = events((0, 45, "run"), (45, 60, "report"))
    b = tr.breakdown(dev, host, spans, 0, 60)
    assert b["device_ops"] == [["k1", 15e-9], ["k2", 10e-9]]
    # gaps (10, 30): mid 20 in run, a launch in flight; (40, 50): mid 45
    # in report; (55, 60): mid 57 in report
    assert dict(map(tuple, b["idle_gaps"])) == {"run/cudaLaunch": 20e-9,
                                                "report/host": 15e-9}
    b = tr.breakdown(dev, events((15, 25, "cudaMemcpyAsync")), events(),
                     0, 60)
    assert dict(map(tuple, b["idle_gaps"])) == {
        "outside/cudaMemcpyAsync": 20e-9, "outside/host": 15e-9}


def test_idle_share_over_the_windows_experiments():
    """Busy time of the profiled experiment over the mean wall time of the
    window's (unprofiled) experiments."""
    run = run_of([("experiment", 2.0, {}), ("experiment", 3.0, {})],
                 trace={"busy_s": 0.25, "window_s": 4.0})
    assert read("device.idle_pct.sims", run) == pytest.approx(90.0)
    assert read("device.idle_pct.sims", run_of()) is None
    assert read("device.idle_pct.sims", run_of(
        [("experiment", 2.0, {})], trace={"busy_s": 0.0,
                                          "window_s": 1.0})) is None


def test_whole_window_ratios():
    spans = [("run", 2.0, {"trip": 100}), ("run", 1.0, {"trip": 200}),
             ("report", 0.004, {}), ("report", 0.002, {}),
             ("setup.route_table", 3.5, {})]
    run = run_of(spans, counters={"syncs": 900, "syncs.trip": 150})
    # ratios of sums over the window, not means of ratios
    assert read("loop.step_ms", run) == pytest.approx(1e3 * 3.0 / 300)
    assert read("report.ms", run) == pytest.approx(3.0)
    assert read("setup.route_table_s", run) == 3.5
    assert read("loop.syncs_per_step", run) == 6.0
    empty = run_of()
    for name in ("loop.step_ms", "report.ms", "setup.route_table_s",
                 "loop.syncs_per_step", "apsp_f32_roofline"):
        assert read(name, empty) is None


def test_apsp_bound_and_share():
    # a 153-node fabric of diameter 4 -> 2 squarings needed
    assert peaks.squarings_needed(4) == 2
    assert peaks.squarings_needed(1) == 0
    assert peaks.squarings_needed(5) == 3
    n = 153
    by_instr = 2 * n ** 3 * 2 / peaks.F32_INSTR_PER_S
    assert peaks.apsp_bound_s(n, 4) == pytest.approx(by_instr)
    assert peaks.apsp_bound_s(n, 1) == pytest.approx(8 * n * n / 3.35e12)
    run = run_of(counters={"apsp.device_s": 1.4e-5, "apsp.n": n,
                           "apsp.max_hops": 4})
    share = read("apsp_f32_roofline", run)
    assert share == pytest.approx(100 * by_instr / 1.4e-5)
    assert 0 < share < 100


def test_leaf_gap():
    assert check.leaf_gap([1.0, 2.0], [1.0, 2.0]) == 0.0
    # judged against the leaf's largest magnitude, not element by element
    assert check.leaf_gap([1.0, 4.002], [1.0, 4.0]) == pytest.approx(5e-4)
    assert check.leaf_gap([1e-9, 4.0], [0.0, 4.0]) == pytest.approx(2.5e-10)
    assert check.leaf_gap([np.nan, 0.0], [np.nan, 0.0]) == 0.0
    assert check.leaf_gap([np.inf, 1.0], [np.inf, 1.0]) == 0.0
    assert check.leaf_gap([1e-30], [0.0]) == math.inf
    assert check.leaf_gap([np.nan], [1.0]) == math.inf
    assert check.leaf_gap([1.0], [np.nan]) == math.inf
    assert check.leaf_gap([-np.inf], [np.inf]) == math.inf
    assert check.leaf_gap([1.0, 2.0], [1.0]) == math.inf
    assert check.diff_count([1, 2, 3], [1, 0, 3]) == 1
    assert check.diff_count([1, 2], [1, 2, 3]) == 3
    worst = {}
    got = {"a": np.array([1.0, 2.0]), "b": np.array([1.0, 3.0]),
           "n": np.array([1, 2])}
    want = {"a": np.array([1.0, 2.0]), "b": np.array([1.0, 2.0]),
            "n": np.array([1, 3])}
    assert check.state_numbers(got, want, worst) == {
        "int_diff": 1, "float_gap": 0.5}
    assert worst == {"float_gap": "b"}


def test_verdict():
    ok, shown = check.verdict({"a": 0, "b": 1e-6}, {"a": 0, "b": 1e-5})
    assert ok and shown == {"a": {"value": 0, "limit": 0},
                            "b": {"value": 1e-6, "limit": 1e-5}}
    assert not check.verdict({"a": 1, "b": 0.0}, {"a": 0, "b": 1e-5})[0]
    assert not check.verdict({"a": float("nan")}, {"a": 0})[0]
