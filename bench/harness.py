"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line.

Set-up builds the configuration's fabric and route table once, loads the
APSP kernel from the checkout's build directory (``build/kernels``, built
by the first run there) and warms the cell's own shapes with one whole
experiment; then it freezes the objects it made out of the garbage
collector's scans.  The window then runs experiments back to back, each
with the next index of the seed's sequence, until ``--seconds`` have
passed; the last one finishes, and every rate is taken over all the work
and all the time up to its end.  With ``--trace 1`` the same window is
run and its spans read; then, after it, the route table's APSP and one
further experiment run under the profiler and one more experiment under
the host-sync counter.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from typing import Optional

from . import check, entries, spec
from . import traffic as gen
from .ref import sim

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_K = 0              # the window's experiments are 1, 2, ...


@dataclasses.dataclass
class Run:
    """What a run recorded, as the per-layer metric readers see it."""

    cell: spec.Cell
    rec: object                       # trace.Recorder of the window
    counters: dict
    trace: Optional[dict] = None      # trace.profile_window's reading


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, started: float) -> dict:
    """Run ``cell`` on ``device`` and return its result line (with the
    numbers compared under ``checked``, last).  ``started`` is the
    ``perf_counter`` reading at process start."""
    import torch

    from . import trace as tr
    from .program import Program

    dev = torch.device(device)
    cfg, t = cell.config, cell.traffic
    entry = entries.ENTRIES[t["entry"]]
    prog = Program(dev)
    _log(f"set-up: imports {time.perf_counter() - started:.3f} s")
    if dev.type == "cuda":
        from repro_torch.kernels.tropical_apsp import kernel
        torch.cuda.init()
        kernel.build()
        torch.cuda.reset_peak_memory_stats(dev)
        _log(f"set-up: card and kernel {time.perf_counter() - started:.3f} s")
    rec = tr.Recorder(dev)
    counters = {}
    topo = prog.topology(cfg)
    with rec.span("setup.route_table"):
        rt = prog.route_table(cfg, topo)
    dep = entries.deploy(prog, cfg, t, topo=topo, route_table=rt)
    _log(f"set-up: route table {time.perf_counter() - started:.3f} s")
    attempted, failed = 0, 0

    def attempt(k, rec):
        """Experiment ``k``, or ``None`` when it raised (counted)."""
        nonlocal attempted, failed
        attempted += 1
        try:
            return entry(dep, seed, k, rec)
        except Exception as exc:          # the run goes on and says so
            failed += 1
            _log(f"experiment {k} failed: {type(exc).__name__}: {exc}")
            return None

    attempt(WARMUP_K, tr.Recorder(dev))
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    _log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    pick = gen.experiment_rng(seed, check.CHECK_DRAW + 1)
    kept, done, sims, k = None, 0, 0, WARMUP_K
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k += 1
        with rec.span("experiment", k=k):
            out = attempt(k, rec)
        if out is None:
            continue
        sims += out.sims
        done += 1
        if pick.random() * done < 1.0:    # one of them, uniformly
            kept = out
        del out
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    _log(f"window: {k - WARMUP_K} experiments ({failed} failed so far), "
         f"{sims} sims in {window_s:.3f} s; each "
         f"{[round(d, 3) for d in rec.durations('experiment')]} s")

    run = Run(cell=cell, rec=rec, counters=counters)
    if trace:
        # nothing is profiled before the window closes: once the profiler
        # has run, every later launch pays for its tracing
        _, apsp_s = tr.apsp_device_s(
            lambda: prog.routing.hop_distances(topo.hop_matrix(), dev), dev)
        counters.update({"apsp.device_s": apsp_s, "apsp.n": topo.n_nodes,
                         "apsp.max_hops": rt.max_hops})
        prec = tr.Recorder(dev)
        _, run.trace = tr.profile_window(lambda: attempt(k + 1, prec), prec)
        exp_s = rec.durations("experiment")
        _log(f"profiled experiment: {run.trace['window_s']:.3f} s "
             f"(the window's took {sum(exp_s) / max(len(exp_s), 1):.3f} s "
             f"on average), busy {run.trace['busy_s']:.3f} s, "
             f"{run.trace['device_ops']} device ops; stop, list, read, "
             f"reduce {run.trace['cost_s']} s")
        if dev.type == "cuda" and t["entry"] == "run":   # one loop a run
            out, n = tr.count_syncs(lambda: attempt(k + 2, tr.Recorder(dev)))
            if out is not None:
                counters.update({"syncs": n, "syncs.trip": out.trip})
            del out

    view = check.program_view(kept, t, seed) if kept is not None else None
    kept = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    worst = {}
    numbers = {}
    if view is not None:
        want = check.reference_view(cfg, t, seed, view["k"], view["lanes"],
                                    sim.build_fabric(cfg))
        numbers = check.numbers(view, want, (topo, rt), worst)
    _log(f"reference: {time.perf_counter() - t1:.3f} s; worst leaves "
         f"{worst}")
    limits = t["check"]["limits"]
    ok, shown = check.verdict({**dict.fromkeys(limits, float("nan")),
                               **numbers}, limits)
    correct = bool(ok and failed == 0 and view is not None)

    if trace:
        metrics = spec.read_metrics(cell.per_layer, run)
    else:
        rates = {"sims_per_s": sims / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": rates[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": attempted,
            "failed": failed + int(view is not None and not ok),
            "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info.update(busy_s=run.trace["busy_s"],
                           window_s=run.trace["window_s"])
        line["breakdown"] = run.trace["breakdown"]
    line["checked"] = shown
    return line


def main(argv, started: float) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(spec.load_benchmark(), args.workload)
    except (OSError, KeyError, ValueError) as exc:
        _log(f"bench: {exc}")
        return 2
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as exc:
        _log(f"bench: the port cannot be imported: {exc}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count()} available")
        return 3
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    started)
    bad = forbidden_modules()
    if bad:
        _log(f"bench: modules loaded that the port must not load: {bad}")
        return 4
    for name, v in line["checked"].items():
        _log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
