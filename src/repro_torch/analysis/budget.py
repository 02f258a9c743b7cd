"""The committed op-budget ledger (experiments/TORCH_OP_BUDGET.json) and
its diff gate (port of ``src/repro/analysis/budget.py``).

The ledger pins, per program, the watched op counts over the loop's first
events plus the loop-carry signature, and the total op count.  The gate
re-derives the counts from the current tree and diffs them:

* a watched op whose count INCREASED fails (a sort crept into the xl
  loop is exactly this diff; the op findings name its source), and so
  does growth of the total op count (rule carry-stability, the gate's
  catch-all, as the reference maps growth of its unspecific primitives);
* ``_local_scalar_dense`` is the one inversion: a DECREASE fails,
  because losing a host read of a device flag means a fast path now runs
  both branches (torchcheck:batched-cond) — the reviewed way to land a
  change that removes syncs on purpose is an allowlist entry;
* a changed carry signature (leaves/bytes/digest) fails;
* entries under ``allowlist`` are waived with a recorded reason.  Budget
  keys are ``<program>:<op>`` (or ``<program>:carry``, ``<program>:ops``);
  op-finding keys name the function (``sort-in-loop:core/engine.py::
  _pop_order``).  Neither holds a line number.

The ledger records the ``torch`` version and the device it was recorded
on.  When the running ``torch`` differs, count and carry mismatches demote
to warnings: aten decompositions shift across releases.  ``device_diff``
holds a run on another device (the card) to the ledger: equal counts,
host reads and host copies left out.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .checkers import HOST_READ, WATCHED
from .rules import Finding

LEDGER_VERSION = 1


def build_ledger(programs: Dict[str, dict],
                 allowlist: Optional[Dict[str, str]] = None,
                 device: str = "cpu") -> dict:
    return {
        "version": LEDGER_VERSION,
        "torch": torch.__version__,
        "device": device,
        "watched": list(WATCHED),
        "allowlist": dict(allowlist or {}),
        "programs": {k: programs[k] for k in sorted(programs)},
    }


def load_ledger(path) -> Optional[dict]:
    p = Path(path)
    if not p.exists():
        return None
    with open(p) as f:
        return json.load(f)


def save_ledger(ledger: dict, path) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(ledger, f, indent=1, sort_keys=True)
        f.write("\n")


def refresh_ledger(programs: Dict[str, dict], old: Optional[dict],
                   device: str = "cpu") -> dict:
    """--update-baseline: new counts, but the reviewed allowlist (and its
    reasons) carries over."""
    allow = dict(old.get("allowlist", {})) if old else {}
    return build_ledger(programs, allow, device)


def _rule_of(op: str) -> str:
    return ("sort-in-loop" if op in ("sort", "argsort")
            else "scatter-in-loop" if op.startswith(("scatter", "index_put",
                                                     "index_add"))
            else "dtype-drift" if op == "_to_copy"
            else "batched-cond" if op == "where"
            else "carry-stability")


def _diff_program(key: str, cur: dict, base: dict,
                  allow: Dict[str, str], demote: bool) -> List[Finding]:
    out: List[Finding] = []
    sev = "warning" if demote else "error"

    def finding(rule: str, akey: str, message: str) -> None:
        if akey not in allow:
            out.append(Finding(rule=rule, where=key, message=message,
                               key=akey, severity=sev))

    cur_loop, base_loop = cur.get("loop", {}), base.get("loop", {})
    for op in WATCHED:
        c, b = int(cur_loop.get(op, 0)), int(base_loop.get(op, 0))
        if op == HOST_READ:
            if c < b:
                finding("batched-cond", f"{key}:{op}",
                        f"host reads fell {b} -> {c}: a fast path on a "
                        "device flag now runs both branches")
        elif c > b:
            finding(_rule_of(op), f"{key}:{op}",
                    f"{op} count grew {b} -> {c} in the engine loop "
                    "(budget: experiments/TORCH_OP_BUDGET.json)")
    c, b = int(cur.get("ops", 0)), int(base.get("ops", 0))
    if c > b:
        finding("carry-stability", f"{key}:ops",
                f"the loop's aten ops grew {b} -> {c} "
                "(budget: experiments/TORCH_OP_BUDGET.json)")
    cur_carry, base_carry = cur.get("carry"), base.get("carry")
    if cur_carry != base_carry:
        finding("carry-stability", f"{key}:carry",
                f"loop carry signature changed: {base_carry} -> "
                f"{cur_carry}")
    return out


def diff_ledger(programs: Dict[str, dict], baseline: dict,
                full_sweep: bool = True) -> Tuple[List[Finding], List[str]]:
    """Diff freshly derived budget rows against the committed baseline.

    Returns ``(findings, notes)``.  ``full_sweep=False`` (a --quick or
    filtered run) skips the missing/extra-program checks — a subset sweep
    legitimately derives fewer rows than the committed file holds.
    """
    findings: List[Finding] = []
    notes: List[str] = []
    allow = baseline.get("allowlist", {})
    demote = baseline.get("torch") != torch.__version__
    if demote:
        notes.append(
            f"baseline torch {baseline.get('torch')} != running torch "
            f"{torch.__version__}: budget mismatches demoted to warnings — "
            "refresh with --update-baseline")
    base_programs = baseline.get("programs", {})
    for key, cur in programs.items():
        base = base_programs.get(key)
        if base is None:
            if full_sweep and f"{key}:new" not in allow:
                # a brand-new program (new scenario / policy choice) is an
                # error even under a version demotion: the committed
                # ledger must cover the whole registry.
                findings.append(Finding(
                    rule="carry-stability", where=key, severity="error",
                    message="program not in the committed budget — run "
                            "tools/torchcheck.py --update-baseline",
                    key=f"{key}:new"))
            continue
        findings += _diff_program(key, cur, base, allow, demote)
    if full_sweep:
        for key in base_programs:
            if key not in programs and f"{key}:gone" not in allow:
                findings.append(Finding(
                    rule="carry-stability", where=key, severity="error",
                    message="program in the committed budget but not in "
                            "the sweep (scenario or signature removed?) — "
                            "run tools/torchcheck.py --update-baseline",
                    key=f"{key}:gone"))
    return findings, notes


def device_diff(programs: Dict[str, dict], baseline: dict
                ) -> List[Finding]:
    """A run's rows on another device than the ledger's (the card against
    the committed CPU ledger) must be EQUAL: integer state, and so every
    branch, is the same on both.  Host reads and host copies are left
    out, as a run on the CPU dispatches no host copy; their count on the
    device is what ``host_syncs`` reports.  Any other difference is a
    fault."""
    out: List[Finding] = []
    base_programs = baseline.get("programs", {})
    for key, cur in programs.items():
        base = base_programs.get(key)
        if base is None:
            out.append(Finding(rule="carry-stability", where=key,
                               message="program not in the ledger",
                               key=f"{key}:new"))
            continue
        diffs = {op: (base["loop"].get(op, 0), cur["loop"].get(op, 0))
                 for op in WATCHED if op != HOST_READ
                 and base["loop"].get(op, 0) != cur["loop"].get(op, 0)}
        ops = [r["ops"] - r["loop"].get(HOST_READ, 0) for r in (base, cur)]
        if ops[0] != ops[1]:
            diffs["ops"] = tuple(ops)
        for k in ("events", "carry", "int64_casts"):
            if base.get(k) != cur.get(k):
                diffs[k] = (base.get(k), cur.get(k))
        if diffs:
            out.append(Finding(
                rule="carry-stability", where=key,
                message=f"counts differ from the {baseline.get('device')} "
                        f"ledger (ledger, this run): {diffs}",
                key=f"{key}:device"))
    return out
