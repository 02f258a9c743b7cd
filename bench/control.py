"""The readings a check's limits are set from, at a cell's own size: the
program's numbers against the reference over many seeds, and the
control's (the reference with every float input stored in bfloat16, in
the program's place) over a few.  Not run by the benchmark's runs.

    python3 bench/control.py --workload paper-usecase.sweep \\
        --seeds 11 12 13 --control-seeds 11 12 13

Prints one JSON line a reading: ``{"side", "workload", "seed", "numbers",
"worst", "seconds", "reference_s"}``.  The program runs on CUDA
(``--device`` to change); each reading is experiment 1 of its seed,
checked as a run checks its sampled experiment.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(cell, side: str, seeds, device: str = "cuda"):
    """``(seed, numbers, worst leaves, seconds, reference seconds)`` for
    each seed on ``side``: ``"program"`` (the port on ``device``) or
    ``"control"``."""
    import torch

    from bench import check, entries
    from bench.program import Program
    from bench.ref import sim
    from bench.trace import Recorder
    cfg, t = cell.config, cell.traffic
    fabric = sim.build_fabric(cfg)
    if side == "program":
        dep = entries.deploy(Program(device), cfg, t)
        entry = entries.ENTRIES[t["entry"]]
    else:
        low = sim.build_fabric(cfg, lower=True)
    for seed in seeds:
        t0 = time.perf_counter()
        lanes = check.sample_lanes(t, seed)
        if side == "program":
            out = entry(dep, seed, 1, Recorder(torch.device(device)))
            got = check.program_view(out, t, seed)
            tables = (dep.topology, dep.route_table)
            del out
        else:
            got = check.reference_view(cfg, t, seed, 1, lanes, low, True)
            tables = low
        t1 = time.perf_counter()
        want = check.reference_view(cfg, t, seed, 1, lanes, fabric)
        worst = {}
        nums = check.numbers(got, want, tables, worst)
        yield (seed, nums, worst, time.perf_counter() - t0,
               time.perf_counter() - t1)


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    from bench import spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(spec.load_benchmark(), args.workload)
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        if not seeds:
            continue
        for seed, nums, worst, secs, ref_s in readings(cell, side, seeds,
                                                       args.device):
            print(json.dumps({"side": side, "workload": cell.name,
                              "seed": seed, "numbers": nums, "worst": worst,
                              "seconds": secs, "reference_s": ref_s}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
