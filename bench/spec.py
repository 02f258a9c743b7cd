"""``BENCHMARK.json`` and the files it names, found by name.

A cell joins a configuration (``configs/<config>.json``, the file
``BENCHMARK.json`` names) with a traffic mix (``traffic/<traffic>.json``);
a per-layer metric is read by ``metrics/<name>.py``, whose ``read(run)``
returns a number or ``None`` when the run has nothing for it to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _listed(metric: dict, cell: str) -> Optional[bool]:
    """Whether ``metric``'s ``workloads`` names ``cell``; ``None`` when
    the metric has no such key."""
    cells = metric.get("workloads")
    return None if cells is None else cell in cells


def load_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench``; raises ``KeyError`` for an unknown
    one."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    # an end-to-end metric without ``workloads`` is every cell's
    e2e = [m for m in bench["end_to_end"] if _listed(m, name) is not False]
    names = {m["name"] for m in e2e}
    # a per-layer metric without ``workloads`` is every cell's that
    # reports the end-to-end metric it moves
    per = [m for m in bench["per_layer"]
           if _listed(m, name) or (_listed(m, name) is None
                                   and m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per)


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``, loaded by its path (a
    metric's name holds dots)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
