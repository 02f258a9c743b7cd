"""torchcheck (repro_torch.analysis, tools/torchcheck.py) on the CPU.

A checker that cannot be tripped is not checking anything: every op
checker gets a doctored program that MUST flag and a clean twin that
MUST pass; every AST rule a doctored and a clean snippet.  The shared AST
rules give the reference's (rule, line) on the same snippets, and the
budget gate gives the reference's findings (rule and key) on the same
synthetic ledgers.  Then the committed ledger: --quick is clean against
it, --seed goes red for every rule, and a second equal-meta run builds
no engine program.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from repro.analysis import astlint as ref_astlint
from repro.analysis import budget as ref_budget
from repro_torch.analysis import (OP_RULES, RULES, analyze, build_ledger,
                                  clean_trace, device_diff, diff_ledger,
                                  doctored_trace, lint_source, lint_tree,
                                  load_ledger, refresh_ledger, static_sigs)
from repro_torch.analysis.checkers import ProgramTrace
from repro_torch.analysis.rules import AST_RULES, NOT_CARRIED
from repro_torch.api import Experiment, PolicyConfig, runners

ROOT = Path(__file__).resolve().parent.parent
LEDGER = ROOT / "experiments" / "TORCH_OP_BUDGET.json"


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# falsifiability: each op checker trips on its doctored program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["sort-in-loop", "scatter-in-loop",
                                  "dtype-drift", "batched-cond"])
def test_doctored_program_trips_checker(rule):
    findings, _ = analyze([doctored_trace(rule)])
    assert any(f.rule == rule and "doctored" in f.where for f in findings), \
        f"doctored program for {rule} did not trip it"


def test_carry_stability_trips_on_divergent_same_meta_carries():
    findings, _ = analyze([clean_trace(), clean_trace(n_packets=96)])
    assert _rules_of(findings) == {"carry-stability"}


def test_missing_engine_loop_is_flagged():
    trace = ProgramTrace(key="t/loopless", kind="serial", scenario="t",
                         meta="m", ops=[], carry=[], axes={"packets": 8})
    findings, _ = analyze([trace])
    assert any("no-loop" in f.key for f in findings)


def test_clean_program_passes_every_checker():
    findings, programs = analyze([clean_trace()])
    assert findings == []
    row = programs["doctored/clean"]
    assert row["loop"]["_local_scalar_dense"] == 3
    assert row["loop"]["sort"] == 0 and row["events"] == 3
    assert row["carry"]["leaves"] == 1


def test_rule_catalog():
    assert set(RULES) == set(OP_RULES) | set(AST_RULES)
    assert set(OP_RULES) == {"sort-in-loop", "scatter-in-loop",
                             "dtype-drift", "carry-stability",
                             "batched-cond"}
    assert "donation" in NOT_CARRIED and "donation" not in RULES


def test_widening_inside_fma32_is_not_drift():
    """fma32's float64 is a recorded divergence: its casts are counted
    (``_to_copy``) but not flagged."""
    import torch
    from repro_torch.analysis.op_walk import OpRecorder
    from repro_torch.core.fp import fma32
    a = torch.ones(64)
    rec = OpRecorder()
    with rec:
        fma32(a, a, a)
    ops = rec.ops
    trace = ProgramTrace(key="t/fma", kind="t", scenario="t", meta="m",
                         ops=ops, carry=[((64,), "float32")],
                         axes={"packets": 64}, events=1,
                         expect_host_read=False)
    findings, programs = analyze([trace])
    assert findings == []
    assert all(op.function.startswith("core/fp.py::fma32") for op in ops
               if op.name == "_to_copy")
    assert programs["t/fma"]["loop"]["_to_copy"] >= 3
    # the same casts outside fma32 are drift
    bad = [dataclasses.replace(op, source="core/x.py:1 (f)") for op in ops]
    findings, _ = analyze([dataclasses.replace(trace, ops=bad)])
    assert "dtype-drift" in _rules_of(findings)


# ---------------------------------------------------------------------------
# AST rules: doctored source flags, clean source passes, disable suppresses
# ---------------------------------------------------------------------------

ENGINE_PATH = "src/repro_torch/core/fake.py"
BENCH_PATH = "benchmarks/torch_fake.py"

AST_CASES = {
    "tracer-cast": (
        "def step(s):\n    return float(s.time)\n",
        "def step(s):\n    return s.time.to(torch.float32)\n",
        ENGINE_PATH),
    "item-call": (
        "def step(s):\n    return s.time.cpu()\n",
        "def step(s):\n    return s.time\n",
        ENGINE_PATH),
    "unseeded-random": (
        "import torch\nx = torch.rand(3)\n",
        "import torch\ng = torch.Generator().manual_seed(0)\n"
        "x = torch.rand(3, generator=g)\n",
        ENGINE_PATH),
    "random-module": (
        "import random\n",
        "import numpy as np\n",
        ENGINE_PATH),
    "naked-timer": (
        "import time\n\ndef bench(f):\n    t0 = time.perf_counter()\n"
        "    f()\n    return time.perf_counter() - t0\n",
        "import time\nimport torch\n\ndef bench(f):\n"
        "    t0 = time.perf_counter()\n    f()\n"
        "    torch.cuda.synchronize()\n"
        "    return time.perf_counter() - t0\n",
        BENCH_PATH),
    "meta-subscript": (
        "def f(meta):\n    return meta['n_links']\n",
        "def f(meta):\n    return meta.n_links\n",
        ENGINE_PATH),
    "frozen-mutation": (
        "def f(meta):\n    meta.n_links = 3\n",
        "import dataclasses\n\ndef f(meta):\n"
        "    return dataclasses.replace(meta, n_links=3)\n",
        ENGINE_PATH),
    "f64-literal": (
        "import torch\nx = torch.zeros(3, dtype=torch.float64)\n",
        "import numpy as np\nx = np.zeros(3, np.float64)\n",
        ENGINE_PATH),
}


@pytest.mark.parametrize("rule", sorted(AST_CASES))
def test_ast_rule_falsifiability(rule):
    doctored, clean, relpath = AST_CASES[rule]
    assert rule in _rules_of(lint_source(doctored, relpath)), \
        f"doctored source for {rule} did not flag"
    assert rule not in _rules_of(lint_source(clean, relpath)), \
        f"clean source for {rule} flagged"


def test_ast_disable_comment_suppresses():
    doctored, _, relpath = AST_CASES["meta-subscript"]
    head, line = doctored.splitlines()[:2]
    on_line = f"{head}\n{line}  # torchcheck: disable=meta-subscript\n"
    assert lint_source(on_line, relpath) == []
    # a comment line above the statement covers every line of it
    above = (f"{head}\n    # torchcheck: disable=tracer-cast: a reason\n"
             "    return (float(s.a),\n            float(s.b))\n")
    assert lint_source(above, relpath) == []
    assert len(lint_source(above.replace("disable=tracer-cast",
                                         "disable=item-call"),
                           relpath)) == 2


def test_ast_rules_scope_outside_engine_is_quiet():
    doctored, _, _ = AST_CASES["tracer-cast"]
    assert lint_source(doctored, "src/repro_torch/api/results_doc.py") != []
    assert lint_source(doctored, "examples/whatever.py") == []


# the AST rules both linters share, on snippets both read the same way:
# each (rule, line) the reference reports, the port reports
SHARED_SNIPPETS = [
    "def step(s, pol):\n    a = float(s.time)\n    b = int(pol['seed'])\n"
    "    return a + b\n",
    "def step(s):\n    x = s.time.item()\n    return x\n",
    "import numpy as np\nx = np.random.rand(3)\n"
    "y = np.random.default_rng(0).random(3)\n",
    "import random\nfrom random import choice\n",
    "import time\n\ndef bench(f):\n    t0 = time.perf_counter()\n"
    "    f()\n    return time.perf_counter() - t0\n",
    "def f(meta, consts):\n    a = meta['n_links']\n    meta.x = 1\n"
    "    consts.y += 2\n    return a\n",
    "class C:\n    def __init__(self, meta):\n        meta.x = 1\n",
    "def step(s):\n"
    "    return float(s.time)  # jaxcheck: disable=tracer-cast\n",
]


@pytest.mark.parametrize("i", range(len(SHARED_SNIPPETS)))
@pytest.mark.parametrize("where", ["core/fake.py", "api/fake.py",
                                   "scenarios/fake.py"])
def test_shared_ast_rules_equal_reference(i, where):
    text = SHARED_SNIPPETS[i]
    ref = {(f.rule, int(f.where.rsplit(":", 1)[1])) for f in
           ref_astlint.lint_source(text, f"src/repro/{where}")}
    port_text = text.replace("jaxcheck:", "torchcheck:")
    got = {(f.rule, int(f.where.rsplit(":", 1)[1])) for f in
           lint_source(port_text, f"src/repro_torch/{where}")}
    assert got == ref
    bench = "benchmarks/fake.py", "benchmarks/torch_fake.py"
    assert {(f.rule, f.where.rsplit(":", 1)[1]) for f in
            lint_source(text, bench[1])} == \
        {(f.rule, f.where.rsplit(":", 1)[1]) for f in
         ref_astlint.lint_source(text, bench[0])}


def test_ast_pass_clean_on_tree():
    assert [f.render() for f in lint_tree(ROOT)] == []


# ---------------------------------------------------------------------------
# the budget gate against the reference's, on the same synthetic ledgers
# ---------------------------------------------------------------------------

# the reference's primitive -> the port's op
NAMES = {"sort": "sort", "scatter": "scatter", "cond": "_local_scalar_dense",
         "select_n": "where", "gather": "gather"}


def _ref_programs():
    return {"scn/serial": {
        "loop": {"sort": 2, "scatter": 1, "cond": 3, "select_n": 10,
                 "gather": 4},
        "eqns": 100, "carry": {"leaves": 5, "bytes": 128, "sig": "abc"}}}


def _port(programs):
    return {k: {"loop": {NAMES[p]: n for p, n in row["loop"].items()},
                "ops": row["eqns"], "carry": row["carry"]}
            for k, row in programs.items()}


def _port_key(key):
    """A reference budget key with its primitive renamed to the op."""
    for p, op in NAMES.items():
        if key.endswith(f":{p}"):
            return key[: -len(p)] + op
    return key


def _mapped(findings, port):
    return {(f.rule, f.key if port else _port_key(f.key), f.severity)
            for f in findings}


def _edit(programs, **changes):
    out = json.loads(json.dumps(programs))
    for prim, delta in changes.items():
        if prim == "carry":
            out["scn/serial"]["carry"]["sig"] = delta
        else:
            out["scn/serial"]["loop"][prim] += delta
    return out


CASES = {
    "sort up": dict(sort=+1), "sort down": dict(sort=-1),
    "scatter up": dict(scatter=+2), "select up": dict(select_n=+1),
    "gather up": dict(gather=+1),
    "host read down": dict(cond=-1), "host read up": dict(cond=+1),
    "carry": dict(carry="zzz"), "several": dict(sort=1, cond=-2,
                                                carry="q"),
}


@pytest.mark.parametrize("version_ok", [True, False])
@pytest.mark.parametrize("allow", [None, "scn/serial:sort",
                                   "scn/serial:carry"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_diff_ledger_equals_reference(case, allow, version_ok):
    import jax
    import torch
    base = _ref_programs()
    cur = _edit(base, **CASES[case])
    allow_ref = {allow: "reviewed"} if allow else {}
    allow_port = {_port_key(allow): "reviewed"} if allow else {}
    ref_base = ref_budget.build_ledger(base, allow_ref)
    port_base = build_ledger(_port(base), allow_port)
    if not version_ok:
        ref_base["jax"] = "0.0.0-not-this-one"
        port_base["torch"] = "0.0.0-not-this-one"
    want, want_notes = ref_budget.diff_ledger(cur, ref_base)
    got, notes = diff_ledger(_port(cur), port_base)
    assert _mapped(got, True) == _mapped(want, False)
    assert bool(notes) == bool(want_notes) == (not version_ok)
    assert ref_base["jax"] != jax.__version__ or version_ok
    assert port_base["torch"] != torch.__version__ or version_ok


def test_diff_ledger_membership_equals_reference():
    base = _ref_programs()
    extra = dict(base, **{"scn/other": {"loop": {}, "eqns": 1,
                                        "carry": None}})
    for cur, full in ((extra, True), (extra, False), ({}, True)):
        want, _ = ref_budget.diff_ledger(cur, ref_budget.build_ledger(base),
                                         full_sweep=full)
        got, _ = diff_ledger(_port(cur), build_ledger(_port(base)),
                             full_sweep=full)
        assert _mapped(got, True) == _mapped(want, False)


def test_op_count_growth_fails_and_refresh_keeps_allowlist():
    base = build_ledger(_port(_ref_programs()), allowlist={"k": "why"})
    grown = _port(_ref_programs())
    grown["scn/serial"]["ops"] += 1
    findings, _ = diff_ledger(grown, base)
    assert {f.key for f in findings} == {"scn/serial:ops"}
    assert refresh_ledger(grown, base)["allowlist"] == {"k": "why"}


def test_device_diff_leaves_out_host_reads_only():
    base = build_ledger(_port(_ref_programs()))
    cur = _port(_ref_programs())
    cur["scn/serial"]["loop"]["_local_scalar_dense"] += 2
    cur["scn/serial"]["ops"] += 2
    cur["scn/serial"]["host_copies"] = 5
    assert device_diff(cur, base) == []
    cur["scn/serial"]["loop"]["where"] -= 1
    assert [f.key for f in device_diff(cur, base)] == ["scn/serial:device"]


# ---------------------------------------------------------------------------
# the committed ledger, the CLI, the build counter
# ---------------------------------------------------------------------------


def test_committed_ledger_covers_the_sweep():
    from repro_torch.scenarios import list_scenarios
    ledger = load_ledger(LEDGER)
    assert ledger is not None and ledger["device"] == "cpu"
    assert len(static_sigs()) == 12
    assert len(ledger["programs"]) == len(list_scenarios()) * 14 == 168
    assert ledger["allowlist"] and all(
        isinstance(r, str) and len(r) > 20
        for r in ledger["allowlist"].values())
    for key in ("sort-in-loop:core/engine.py::_sdn_scan:sort",
                "sort-in-loop:core/engine.py::_pop_order:sort"):
        assert key in ledger["allowlist"]


def test_cli_quick_clean_exits_zero(capsys):
    tool = _load_tool("torchcheck")
    assert tool.main(["--device", "cpu", "--quick", "--quiet"]) == 0
    assert "0 error(s)" in capsys.readouterr().out


@pytest.mark.parametrize("rule", sorted(OP_RULES))
def test_cli_seeded_regression_exits_nonzero(rule, capsys):
    tool = _load_tool("torchcheck")
    rc = tool.main(["--device", "cpu", "--quick", "--quiet", "--no-ast",
                    "--seed", rule])
    out = capsys.readouterr().out
    assert rc != 0
    assert f"] {rule}:" in out and "doctored/" in out


def test_cli_refuses_partial_baseline_update(tmp_path):
    tool = _load_tool("torchcheck")
    path = tmp_path / "b.json"
    rc = tool.main(["--device", "cpu", "--quick", "--quiet", "--no-ast",
                    "--update-baseline", "--baseline", str(path)])
    assert rc == 2 and not path.exists()


def test_build_count_does_not_move_on_an_equal_meta_run():
    runners.cache_clear()
    assert runners.build_count() == 0
    pol = PolicyConfig()
    Experiment("paper-fabric", pol, device="cpu").run()
    n = runners.build_count()
    assert n == 1
    Experiment("paper-fabric", pol, device="cpu").run()
    assert runners.build_count() == n
    Experiment("leaf-spine", pol, device="cpu").run()
    assert runners.build_count() == n + 1
    exp = Experiment("paper-fabric", [PolicyConfig(seed=i) for i in
                                      range(3)], device="cpu")
    exp.run_fleet(width=2, chunk_steps=8)
    m = runners.build_count()
    exp.run_fleet(width=2, chunk_steps=8)
    assert runners.build_count() == m > n + 1


def test_traced_ops_leaves_cache_and_counter_untouched():
    from repro_torch.analysis.programs import trace_serial
    runners.cache_clear()
    trace = trace_serial("paper-fabric", "cpu", events=4)
    assert runners.build_count() == 0 and runners.cache_size() == 0
    assert trace.events == 4 and len(trace.ops) > 0
    assert sum(op.name == "_local_scalar_dense" for op in trace.ops) >= 4
