"""Rule catalog + finding model of torchcheck, the port's static and
dynamic analysis (port of ``src/repro/analysis/rules.py``).

Every rule has a stable kebab-case id, cited in code and docs as a
``torchcheck:<id>`` token; the README's port section documents each.  The
reference's ids are kept where the meaning carries over.

Findings carry two locations: ``where`` is the precise spot (``file:line``
for AST findings, ``program @ op #i [source]`` for op findings) and
``key`` is the STABLE identity used by the ``allowlist`` of
``experiments/TORCH_OP_BUDGET.json``; keys never embed line numbers, so
an allowlisted finding survives unrelated edits to the same file.  An op
finding's key names the function the op came from, not the program, so
one allowlist entry covers that function in every scenario's program.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # rule id from RULES
    where: str         # file:line or "<program> @ op #<i> [<source>]"
    message: str
    key: str           # stable allowlist key (no line numbers)
    severity: str = "error"

    def render(self) -> str:
        return (f"[{self.severity}] {self.rule}: {self.message}\n"
                f"    at  {self.where}\n"
                f"    key {self.key}")


# --- op-pass rules (repro_torch.analysis.checkers) ------------------------
OP_RULES = {
    "sort-in-loop": (
        "a sort over the packet axis among the ops of the engine loop's "
        "events"),
    "scatter-in-loop": (
        "a scatter (scatter, scatter_add, scatter_reduce, index_put, "
        "index_add) whose updates span the whole packet axis among the ops "
        "of the engine loop's events (single-element pops and segment-sums "
        "are budgeted, not forbidden)"),
    "dtype-drift": (
        "a 64-bit leaf in the loop carry, or a widening float cast "
        "(bf16/f16 -> f32, f32 -> f64) in the loop outside core/fp.py::fma32 "
        "and core/engine.py::_sum32, whose float64 is a recorded "
        "divergence; int64 casts (PyTorch indexes in int64) are counted, "
        "not forbidden"),
    "carry-stability": (
        "programs sharing a SimMeta and kind disagree on the loop carry "
        "structure (leaf count / shapes / dtypes)"),
    "batched-cond": (
        "an engine loop with no host read of a device flag at all (no "
        "_local_scalar_dense): every skip-when-idle fast path, a Python "
        "branch on a device flag, has been replaced by running both "
        "branches"),
}

# --- AST-pass rules (repro_torch.analysis.astlint) ------------------------
AST_RULES = {
    "tracer-cast": (
        "float()/int()/bool() applied to a likely device tensor (a "
        "state/consts attribute, a pol/aux/cache entry, or a torch call) "
        "in engine code — a host sync on the card"),
    "item-call": (
        ".item(), .tolist() or .cpu() in engine code — a host read that "
        "waits for the device"),
    "unseeded-random": (
        "legacy global numpy RNG (np.random.<fn>), or torch.rand* without "
        "generator= — use a seeded generator so sweeps stay deterministic"),
    "random-module": (
        "the stdlib random module — unseeded, process-global, and "
        "invisible to the scenario seed plumbing"),
    "naked-timer": (
        "a function that brackets work with two timer reads but never "
        "synchronises (torch.cuda.synchronize, .cpu(), .item()) — with "
        "asynchronous launches the timer measures the launch, not the work"),
    "meta-subscript": (
        'meta["..."] dict-style access where the frozen SimMeta is '
        "required — attribute access is the supported spelling"),
    "frozen-mutation": (
        "attribute assignment on a consts/meta object — EngineConsts and "
        "SimMeta are frozen; use _replace()/dataclasses.replace()"),
    "f64-literal": (
        "torch.float64 / torch.double in engine code — the engine is "
        "float32 end to end but for fma32 and _sum32"),
}

# the reference's ``donation`` rule has no counterpart: PyTorch has no
# buffer donation (a step that works in place keeps one copy by itself)
NOT_CARRIED = {"donation": "PyTorch has no buffer donation"}

RULES = {**OP_RULES, **AST_RULES}
