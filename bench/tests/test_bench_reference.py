"""The reference agrees with the port at a tiny size, through the whole
harness; its fabric and routes are the paper's; and a lane's final state
does not depend on the lanes beside it, the premise of comparing a
sample of them."""
import itertools

import numpy as np

from bench_tiny import SEED, run_tiny, tiny_cell


def test_port_agrees_with_reference(fresh_caches):
    line = run_tiny(seeds=2, per_combo=2)
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert line["checked"]["route_diff"]["value"] == 0
    assert line["checked"]["int_diff"]["value"] == 0
    assert line["checked"]["float_gap"]["value"] == 0
    # the energy totals are sums in another order: float32 rounding
    assert line["checked"]["report_gap"]["value"] < 1e-6
    assert set(line["metrics"]) == {"setup_s", "sims_per_s"}
    assert list(line)[-1] == "checked"


def test_traced_run_reads_its_per_layer_metrics(fresh_caches):
    line = run_tiny(trace=True)
    assert line["correct"]
    # the CPU has no device trace: the device metrics and the roofline
    # find nothing to read and are left out
    assert set(line["metrics"]) == {"setup.route_table_s", "loop.step_ms",
                                    "report.ms"}
    assert "busy_s" in line["device"]


def test_sample_covers_every_combination():
    from bench import check
    c = tiny_cell(seeds=16, per_combo=2)
    lanes = check.sample_lanes(c.traffic, SEED)
    assert len(lanes) == 32 and lanes == sorted(set(lanes))
    assert sorted(np.bincount(np.asarray(lanes) % 16)) == [2] * 16
    assert check.sample_lanes(c.traffic, SEED + 1) != lanes


def test_fabric_and_routes():
    """Fig. 9's 16 hosts, 20 switches and SAN by 65 cables; every
    candidate is a shortest chain of links, the candidates of a pair are
    distinct and in descending order; two hosts in different pods have
    2 x 4 x 2 routes (aggregation, core cable, core-side cable)."""
    from bench.ref import fabric
    f = fabric.paper_fat_tree()
    assert (f.n_hosts, f.n_switches, f.n_nodes, len(f.link_src)) == \
        (16, 20, 37, 130)
    assert sorted(set(f.link_bw.tolist())) == [1e9, 4e9]
    r = fabric.candidate_routes(f, 16)
    dist = fabric.hop_counts(f)
    assert r.max_hops == 6
    for s, d in itertools.product(range(f.n_nodes), repeat=2):
        p = s * f.n_nodes + d
        cands = [tuple(x for x in r.routes[p, k] if x >= 0)
                 for k in range(r.n_cand[p])]
        assert cands == sorted(set(cands), reverse=True)
        for c in cands:
            assert len(c) == dist[s, d]
            assert f.link_src[c[0]] == s and f.link_dst[c[-1]] == d
            assert all(f.link_dst[a] == f.link_src[b]
                       for a, b in zip(c, c[1:]))
    assert r.n_cand[0 * 37 + 15] == 16 and r.n_cand[36 * 37 + 0] == 2


def test_lanes_are_independent():
    """A lane's final state in the port is the same whatever other lanes
    share its batch."""
    import torch
    from bench import entries, traffic as gen
    from bench.program import Program
    from bench.trace import Recorder
    cell = tiny_cell(seeds=2)
    dep = entries.deploy(Program("cpu"), cell.config, cell.traffic)
    rec = Recorder(torch.device("cpu"))
    whole = entries.sweep(dep, SEED, 1, rec).result.states
    pick = [3, 12, 25]
    dep.lanes = [gen.lanes(cell.traffic)[i] for i in pick]
    part = entries.sweep(dep, SEED, 1, rec).result.states
    for a, b in zip(whole, part):
        np.testing.assert_array_equal(a[0, pick].numpy(), b[0].numpy())
