"""torchcheck: analysis of the engine's recorded ops and of the port's
source tree (port of ``src/repro/analysis``, jaxcheck).

Two passes, one gate:

* the **op pass** (``programs`` + ``checkers``) runs every registry
  scenario x program kind for its first events under a dispatch-mode
  recorder (``op_walk``) and checks what the engine loop dispatched: no
  packet-axis sorts or full-width scatters (the two the engine keeps are
  allowlisted with their reason), no 64-bit carry leaf or silent float
  widening, the host reads that are the fast paths survive, and the
  loop carry is stable across same-meta scenarios;
* the **AST pass** (``astlint``) lints the source for host syncs in
  engine code, unseeded RNG, naked benchmark timers, legacy meta
  subscripts and frozen-struct mutation;
* the **budget gate** (``budget``) diffs per-program op counts against
  the committed ``experiments/TORCH_OP_BUDGET.json``.

Everything drives through ``tools/torchcheck.py``; the falsifiability
tests in ``tests/test_torch_torchcheck.py`` prove each checker fires on a
doctored program and stays quiet on a clean one.
"""
from .rules import AST_RULES, OP_RULES, RULES, Finding  # noqa: F401
from .checkers import WATCHED, ProgramTrace, analyze  # noqa: F401
from .astlint import lint_source, lint_tree  # noqa: F401
from .budget import (build_ledger, device_diff, diff_ledger,  # noqa: F401
                     load_ledger, refresh_ledger, save_ledger)
from .programs import (clean_trace, doctored_trace, iter_traces,  # noqa: F401
                       static_sigs)
