#!/usr/bin/env python3
"""torchcheck — analysis of the engine's recorded ops and of the port's
source tree, plus the engine loop's op-budget gate (port of
``tools/jaxcheck.py``).

Two passes:

* **ops**: runs every registry scenario x program kind (serial runner,
  fleet chunk per static policy signature, streaming refill) for its
  first 32 events under a dispatch-mode recorder, on ``--device``, and
  runs the checkers over what the loop dispatched (packet-axis sort /
  scatter, dtype drift, lost host-read fast paths, carry stability).
  Per-program op counts are diffed against the committed ledger
  ``experiments/TORCH_OP_BUDGET.json``.  Findings whose key the ledger's
  ``allowlist`` holds are waived, each with its recorded reason.
* **ast**: lints ``src/repro_torch/{core,api,scenarios}`` and
  ``benchmarks/torch_*.py`` for host syncs in engine code, unseeded RNG,
  naked benchmark timers, ...

``--device`` defaults to ``cuda`` and raises without a GPU; the committed
ledger is recorded with ``--device cpu`` and stores its device.  A run on
another device than the ledger's is held to it exactly (``device_diff``:
host reads and host copies left out, as a run on the CPU dispatches no
host copy), and reports its host syncs (``OpRecord.host_sync``).  Exit
status is nonzero iff any error-severity finding survives.

  PYTHONPATH=src python tools/torchcheck.py --device cpu \\
      --json --baseline experiments/TORCH_OP_BUDGET.json   # the gate
  PYTHONPATH=src python tools/torchcheck.py --device cpu --quick
  PYTHONPATH=src python tools/torchcheck.py --device cpu --update-baseline
  PYTHONPATH=src python tools/torchcheck.py --device cpu --quick \\
      --seed sort-in-loop   # falsifiability: MUST exit nonzero
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

DEFAULT_BASELINE = "experiments/TORCH_OP_BUDGET.json"
KINDS = ("serial", "fleet", "refill")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="torchcheck",
        description="op and AST analysis + the engine's op-budget gate")
    ap.add_argument("--json", metavar="PATH", nargs="?", default=None,
                    const="experiments/torchcheck.json",
                    help="write the machine-readable findings report "
                         "(default path when the flag is bare)")
    ap.add_argument("--baseline", metavar="PATH", default=DEFAULT_BASELINE,
                    help="committed op-budget ledger to diff against, "
                         "whose allowlist waives findings (default "
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from the current sweep, "
                         "preserving its allowlist")
    ap.add_argument("--device", default="cuda",
                    help="where the programs run (default cuda; raises "
                         "without a GPU)")
    ap.add_argument("--scenarios", nargs="+", default=None,
                    help="restrict the op sweep to these registry "
                         "scenarios (default: all)")
    ap.add_argument("--kinds", nargs="+", default=KINDS, choices=KINDS,
                    help="program kinds to run")
    ap.add_argument("--max-sigs", type=int, default=None,
                    help="cap the fleet static-signature sweep (default: "
                         "every routing x traffic x placement combo)")
    ap.add_argument("--quick", action="store_true",
                    help="paper-fabric only, one fleet signature — the "
                         "fast pre-commit pass")
    ap.add_argument("--seed", metavar="RULE", default=None,
                    help="inject a doctored program violating RULE "
                         "(falsifiability check: the run must go red)")
    ap.add_argument("--no-ops", action="store_true",
                    help="skip the op pass")
    ap.add_argument("--no-ast", action="store_true",
                    help="skip the AST pass")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-program progress lines")
    return ap.parse_args(argv)


def host_syncs(trace) -> int:
    """The host syncs a program's recorded ops dispatched
    (``OpRecord.host_sync``: scalar reads of device tensors, blocking
    copies between the host and the device, device ``nonzero``)."""
    return sum(op.host_sync for op in trace.ops)


def run(args) -> dict:
    """Both passes; returns the report (``errors``/``warnings`` lists of
    ``Finding``s, ``programs`` rows, ``notes``, ``syncs`` per program)."""
    from repro_torch.analysis import (analyze, clean_trace, device_diff,
                                      diff_ledger, doctored_trace,
                                      iter_traces, lint_tree, load_ledger,
                                      refresh_ledger, save_ledger,
                                      static_sigs)
    from repro_torch.device import resolve

    t0 = time.perf_counter()
    findings, programs, notes, syncs, waived = [], {}, [], {}, []
    scenarios, sigs = args.scenarios, None
    if args.quick:
        scenarios = scenarios or ["paper-fabric"]
        sigs = static_sigs()[:1]
    elif args.max_sigs is not None:
        sigs = static_sigs()[: args.max_sigs]
    # the missing/extra-program ledger checks only make sense when the
    # sweep covers everything the ledger covers
    full_sweep = (scenarios is None and sigs is None
                  and tuple(args.kinds) == KINDS)
    device = resolve(args.device).type

    if not args.no_ops:
        progress = (lambda s: None) if args.quiet else \
            (lambda s: print(f"  {s}", flush=True))
        traces = list(iter_traces(scenarios, sigs, kinds=args.kinds,
                                  device=device, progress=progress))
        syncs = {t.key: host_syncs(t) for t in traces}
        if args.seed:
            if args.seed != "carry-stability":
                traces.append(doctored_trace(args.seed))
            else:
                # two same-meta programs with different carries
                traces += [clean_trace(), clean_trace(n_packets=96)]
        findings, programs = analyze(traces)

        baseline_path = args.baseline
        baseline = load_ledger(ROOT / baseline_path)
        if baseline is None and not args.update_baseline:
            raise SystemExit(f"no baseline at {baseline_path} — run "
                             "--update-baseline to create it")
        allow = (baseline or {}).get("allowlist", {})
        waived = [f for f in findings if f.key in allow]
        findings = [f for f in findings if f.key not in allow]
        if args.update_baseline:
            if args.seed or not full_sweep:
                raise SystemExit("refusing --update-baseline on a partial "
                                 "or seeded sweep (drop --quick/--scenarios"
                                 "/--kinds/--seed)")
            ledger = refresh_ledger(programs, baseline, device)
            save_ledger(ledger, ROOT / baseline_path)
            notes.append(f"wrote {baseline_path} "
                         f"({len(ledger['programs'])} programs)")
        elif baseline is not None:
            # the doctored program is never in the ledger; keep its
            # findings but skip the its-not-in-the-budget noise
            budget = {k: v for k, v in programs.items()
                      if not k.startswith("doctored/")}
            if baseline.get("device", "cpu") == device:
                diff, notes = diff_ledger(budget, baseline,
                                          full_sweep=full_sweep)
            else:
                diff = device_diff(budget, baseline)
                notes.append(f"held to the {baseline.get('device')} ledger "
                             f"on {device}: counts equal, host reads and "
                             "host copies left out")
            findings += diff

    if not args.no_ast:
        findings += lint_tree(ROOT)

    return {
        "errors": [f for f in findings if f.severity == "error"],
        "warnings": [f for f in findings if f.severity != "error"],
        "waived": waived, "programs": programs, "notes": notes,
        "syncs": syncs, "device": device,
        "wall_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch.analysis import OP_RULES, RULES

    if args.list_rules:
        for rid in sorted(RULES):
            kind = "ops" if rid in OP_RULES else "ast"
            print(f"torchcheck:{rid:16} [{kind}] {RULES[rid]}")
        return 0
    try:
        rep = run(args)
    except SystemExit as e:
        print(e)
        return 2
    for note in rep["notes"]:
        print(f"note: {note}")
    for f in rep["errors"] + rep["warnings"]:
        print(f.render())
    print(f"torchcheck: {len(rep['programs'])} program(s) run on "
          f"{rep['device']}, {len(rep['errors'])} error(s), "
          f"{len(rep['warnings'])} warning(s), {len(rep['waived'])} "
          f"allowlisted, in {rep['wall_s']:.1f}s")
    if args.json:
        report = {
            "tool": "torchcheck", "device": rep["device"],
            "programs": rep["programs"], "host_syncs": rep["syncs"],
            "notes": rep["notes"],
            "errors": [dataclasses.asdict(f) for f in rep["errors"]],
            "warnings": [dataclasses.asdict(f) for f in rep["warnings"]],
            "allowlisted": sorted({f.key for f in rep["waived"]}),
            "wall_s": rep["wall_s"],
        }
        path = ROOT / args.json
        os.makedirs(path.parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {args.json}")
    return 1 if rep["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
