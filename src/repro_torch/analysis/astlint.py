"""AST lint pass: engine-hygiene rules over the port's source tree (port
of ``src/repro/analysis/astlint.py``), stdlib ``ast`` only.

Scope: *engine* rules (host syncs, 64-bit literals) run over
``src/repro_torch/{core,api}``; benchmark rules (naked timers) over
``benchmarks/torch_*.py``; determinism rules (RNG hygiene) and the
frozen-struct rules over everything scanned (``src/repro_torch/{core,
api,scenarios}`` and ``benchmarks/torch_*.py``).  Every rule id lives in
``repro_torch.analysis.rules``.

On the card a host sync (``.item()``, ``.cpu()``, ``.tolist()``, or a
builtin ``int()``/``float()``/``bool()`` of a device tensor) waits for
every queued kernel.  The engine has some on purpose (the loop's done
check, the loops sized by a device count): each carries a
``# torchcheck: disable=<rule>[,<rule>...]`` comment, with the reason, on
its line or on comment lines just above the statement that holds it: the
AST analogue of a budget allowlist entry.  The op budget counts the same
reads at run time.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Sequence, Set

from .rules import AST_RULES, Finding

ENGINE_PREFIXES = ("src/repro_torch/core/", "src/repro_torch/api/")
SCAN_PREFIXES = ENGINE_PREFIXES + ("src/repro_torch/scenarios/",
                                   "benchmarks/torch_")
TIMER_PREFIXES = ("benchmarks/torch_",)

# names whose attributes are device tensors inside the step by repo
# convention: s/sc = SimState (+ step carry), pol/aux/cache = the policy,
# auxiliary and endpoint-cache dicts
TRACED_ATTR_ROOTS = {"s", "sc"}
TRACED_SUBSCRIPT_ROOTS = {"pol", "aux", "cache"}

# frozen structures: attribute assignment on these object names is a
# mutation of EngineConsts / SimMeta outside a constructor
FROZEN_ROOTS = {"meta", "consts"}

SAFE_NP_RANDOM = {"default_rng", "RandomState", "Generator", "SeedSequence",
                  "PCG64", "Philox", "BitGenerator"}
TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}

TIMER_ATTRS = {"time", "perf_counter", "monotonic", "process_time"}
# a method call that waits for the device
SYNC_METHODS = {"item", "cpu", "tolist"}
# reductions whose builtin cast reads one value on the host
REDUCTIONS = {"max", "min", "sum", "any", "all"}
SYNC_CALLS = {"torch.cuda.synchronize"}

DTYPE64 = {"float64", "double"}

_DISABLE_RE = re.compile(r"#\s*torchcheck:\s*disable=([a-z0-9,\-]+)")


def _suppressions(text: str, tree: ast.AST) -> Dict[int, Set[str]]:
    """line -> rules disabled there: by a comment on the line, or by one
    on the comment lines just above the innermost statement holding it
    (which covers every line of that statement)."""
    lines = text.splitlines()
    on_line: Dict[int, Set[str]] = {}
    above: Dict[int, Set[str]] = {}      # first code line -> rules
    pending: Set[str] = set()
    for i, line in enumerate(lines, 1):
        m = _DISABLE_RE.search(line)
        rules = set(m.group(1).split(",")) if m else set()
        if line.strip().startswith("#"):
            pending |= rules
            continue
        on_line[i] = rules
        if pending:
            above[i] = pending
        pending = set()
    out = {i: set(r) for i, r in on_line.items() if r}
    stmts = sorted(((n.lineno, n.end_lineno) for n in ast.walk(tree)
                    if isinstance(n, ast.stmt)),
                   key=lambda se: se[1] - se[0])
    for i in range(1, len(lines) + 1):
        inner = next((a for a, b in stmts if a <= i <= b), None)
        if inner is not None and inner in above:
            out.setdefault(i, set()).update(above[inner])
    return out


def _name_of(node) -> str:
    return node.id if isinstance(node, ast.Name) else ""


def _attr_chain(node) -> str:
    """Dotted name for Name/Attribute chains ('torch.cuda.synchronize'),
    '' if the chain roots in something else (a call, a subscript, ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.engine = relpath.startswith(ENGINE_PREFIXES)
        self.timers = relpath.startswith(TIMER_PREFIXES)
        self.meta_rule = (relpath.startswith("src/repro_torch/")
                          and not relpath.endswith("simmeta.py"))
        self.func_stack: List[str] = []
        self.findings: List[Finding] = []

    # -- plumbing ----------------------------------------------------------

    def _scope(self) -> str:
        return self.func_stack[-1] if self.func_stack else "<module>"

    def _add(self, rule: str, node, message: str) -> None:
        self.findings.append(Finding(
            rule=rule,
            where=f"{self.relpath}:{node.lineno}",
            message=message,
            key=f"{rule}:{self.relpath}:{self._scope()}"))

    # -- function scope (naked-timer + frozen-mutation constructor rule) --

    def _visit_func(self, node) -> None:
        self.func_stack.append(node.name)
        if self.timers:
            self._check_naked_timer(node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _check_naked_timer(self, fn) -> None:
        """torchcheck:naked-timer — a function bracketing work with two or
        more timer reads but never synchronising measures the launches,
        not the work."""
        n_timers, synced = 0, False
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func)
                if chain.startswith("time.") and \
                        chain.split(".", 1)[1] in TIMER_ATTRS:
                    n_timers += 1
                if chain in SYNC_CALLS or (
                        isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in SYNC_METHODS):
                    synced = True
        if n_timers >= 2 and not synced:
            self.func_stack.append(fn.name)   # key under the fn itself
            self._add("naked-timer", fn,
                      f"{fn.name}() reads a timer {n_timers}x but never "
                      "synchronises (torch.cuda.synchronize, .cpu(), "
                      ".item())")
            self.func_stack.pop()

    # -- calls: host syncs, RNG -------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fname = _name_of(node.func)
        if self.engine and fname in {"float", "int", "bool"} and node.args:
            if self._touches_device(node.args[0]):
                self._add("tracer-cast", node,
                          f"{fname}() on a likely device tensor — a host "
                          "sync on the card")
        if self.engine and isinstance(node.func, ast.Attribute) \
                and node.func.attr in SYNC_METHODS and not node.args:
            self._add("item-call", node,
                      f".{node.func.attr}() reads a tensor on the host: a "
                      "sync on the card")
        chain = _attr_chain(node.func)
        if chain.startswith(("np.random.", "numpy.random.")):
            leaf = chain.rsplit(".", 1)[1]
            if leaf not in SAFE_NP_RANDOM:
                self._add("unseeded-random", node,
                          f"{chain}() uses the process-global legacy RNG")
        if chain.startswith("torch.") and \
                chain.split(".", 1)[1] in TORCH_RANDOM and \
                not any(k.arg == "generator" for k in node.keywords):
            self._add("unseeded-random", node,
                      f"{chain}() without generator= draws from torch's "
                      "process-global RNG")
        self.generic_visit(node)

    def _touches_device(self, node) -> bool:
        """The reference's traced roots (state attributes, pol/aux/cache
        entries), a ``torch.*`` call or a reduction method (``.max()``,
        ``.any()``, ...) inside the expression."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and \
                    _name_of(sub.value) in TRACED_ATTR_ROOTS:
                return True
            if isinstance(sub, ast.Subscript) and \
                    _name_of(sub.value) in TRACED_SUBSCRIPT_ROOTS:
                return True
            if isinstance(sub, ast.Call) and (
                    _attr_chain(sub.func).startswith("torch.")
                    or isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in REDUCTIONS and not sub.args):
                return True
        return False

    # -- imports: the stdlib random module --------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "random" or alias.name.startswith("random."):
                self._add("random-module", node,
                          "stdlib random is unseeded and process-global")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "random":
            self._add("random-module", node,
                      "stdlib random is unseeded and process-global")
        self.generic_visit(node)

    # -- subscripts: legacy meta["..."] access ----------------------------

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self.meta_rule and _name_of(node.value) == "meta":
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                self._add("meta-subscript", node,
                          f'meta[{sl.value!r}] — use meta.{sl.value} on '
                          "the frozen SimMeta")
        self.generic_visit(node)

    # -- assignments: frozen-struct mutation ------------------------------

    def _check_frozen(self, target) -> None:
        if isinstance(target, ast.Attribute) and \
                _name_of(target.value) in FROZEN_ROOTS and \
                self._scope() not in ("__init__", "__post_init__"):
            self._add("frozen-mutation", target,
                      f"assignment to {_name_of(target.value)}."
                      f"{target.attr} — EngineConsts/SimMeta are frozen; "
                      "use _replace()/dataclasses.replace()")

    def visit_Assign(self, node: ast.Assign) -> None:
        if self.relpath.startswith("src/repro_torch/"):
            for t in node.targets:
                self._check_frozen(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self.relpath.startswith("src/repro_torch/"):
            self._check_frozen(node.target)
        self.generic_visit(node)

    # -- 64-bit torch dtype literals --------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.engine and node.attr in DTYPE64 and \
                _attr_chain(node) == f"torch.{node.attr}":
            self._add("f64-literal", node,
                      f"torch.{node.attr} in engine code — the engine is "
                      "float32 end to end (np 64-bit on the host is fine)")
        self.generic_visit(node)


def lint_source(text: str, relpath: str) -> List[Finding]:
    """Lint one file's source.  ``relpath`` (posix, repo-relative) decides
    which rule scopes apply."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(rule="tracer-cast", severity="error",
                        where=f"{relpath}:{e.lineno or 0}",
                        message=f"unparsable: {e.msg}",
                        key=f"parse:{relpath}")]
    linter = _Linter(relpath)
    linter.visit(tree)
    suppressed = _suppressions(text, tree)
    out = []
    for f in linter.findings:
        line = int(f.where.rsplit(":", 1)[1])
        if f.rule in suppressed.get(line, ()):
            continue
        out.append(f)
    return out


def lint_tree(root, prefixes: Sequence[str] = SCAN_PREFIXES) -> List[Finding]:
    """Lint every .py file under the scanned prefixes of ``root`` (a
    prefix that is not a directory matches files by name)."""
    root = Path(root)
    findings: List[Finding] = []
    for prefix in prefixes:
        base = root / prefix
        if base.is_dir():
            files = sorted(base.rglob("*.py"))
        else:
            files = sorted(base.parent.glob(base.name + "*.py"))
        for py in files:
            rel = py.relative_to(root).as_posix()
            findings += lint_source(py.read_text(), rel)
    return findings


assert set(AST_RULES) >= {"tracer-cast", "item-call", "unseeded-random",
                          "random-module", "naked-timer", "meta-subscript",
                          "frozen-mutation", "f64-literal"}
