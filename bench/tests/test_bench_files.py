"""The harness finds every cell and metric from files, and
``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from bench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_from_files(cell):
    from bench import spec
    c = spec.load_cell(bench(), cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert c.traffic["entry"] == "run"
    assert set(c.traffic["check"]["limits"]) == {
        "route_diff", "int_diff", "float_gap", "report_gap"}


@pytest.mark.parametrize("metric",
                         [m["name"] for m in bench()["per_layer"]])
def test_metric_reader_loads(metric):
    from bench import spec
    assert callable(spec.metric_reader(metric))


def test_layers_are_named_alike():
    b = bench()
    layers = {m["layer"] for m in b["per_layer"]}
    assert layers <= {"front door, setup", "kernel", "event loop",
                      "report", "device"}
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


def test_config_files_are_under_paths():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("bench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
