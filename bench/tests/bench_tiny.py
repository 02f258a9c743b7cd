"""A tiny version of the benchmark's cell (the paper fabric with one job
of each class, one or two policy seeds), run through the harness on the
CPU."""
import copy
import dataclasses
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 11       # past 32 signed bits, as the driver's are
CELL = "paper-usecase.sweep"


def tiny_cell(name: str = CELL, seeds: int = 1, per_combo: int = 1):
    """Cell ``name`` of ``BENCHMARK.json`` cut to a size a CPU test holds:
    one job a class, ``seeds`` policy seeds, ``per_combo`` lanes of each
    combination compared."""
    from bench import spec
    cell = spec.load_cell(spec.load_benchmark(), name)
    cfg, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    for row in cfg["jobs"]["rows"]:
        row["count"] = 1
    t["lanes"]["seeds"] = seeds
    t["check"]["per_combo"] = per_combo
    return dataclasses.replace(cell, config=cfg, traffic=t)


def run_tiny(seconds: float = 0.5, trace: bool = False, **kw) -> dict:
    from bench import harness
    return harness.run_cell(tiny_cell(**kw), SEED, seconds, trace, "cpu",
                            time.perf_counter())
