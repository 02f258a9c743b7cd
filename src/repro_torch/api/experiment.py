"""``Experiment`` — the front door for running simulations (DESIGN.md §6).

Port of ``src/repro/api/experiment.py`` for one scenario::

    Experiment(scenarios="paper-fabric",
               policies=[("sdn", PolicyConfig(routing=ROUTE_SDN)),
                         ("legacy", PolicyConfig(routing=ROUTE_LEGACY))],
               seeds=range(3)).run()

runs every policy × seed as one lane of one engine loop on ``device``
(``None`` = CUDA) and returns a ``Results``.  Not ported yet, each raising
``NotImplementedError`` with its ROADMAP item: several scenarios in one
run (the packed multi-topology grid, queue 1 item 4), the ``failures=``,
``ctrl=`` and ``degradation=`` axes (items 5, 6, 7), ``run_fleet`` (item
8) and ``run_stream`` (item 9).
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

from ..core import policies as policy_mod
from ..core.engine import lane_policies, make_consts, make_packed_simulator
from ..core.mapreduce import SimSetup
from ..core.policies import as_policy_arrays, policy_fields
from ..device import resolve
from .results import Results


def _build_scenario(item, device) -> Tuple[str, SimSetup]:
    """-> (name, SimSetup) from a registry name, Scenario, or SimSetup."""
    if isinstance(item, str):
        from ..scenarios import get_scenario
        sc = get_scenario(item)
        return sc.name, sc.build(device)
    if isinstance(item, SimSetup):
        return "scenario", item
    if hasattr(item, "build"):                   # scenarios.Scenario
        return getattr(item, "name", "scenario"), item.build(device)
    raise TypeError(f"cannot interpret {type(item).__name__} as a scenario")


def _policy_label(pol) -> str:
    """Descriptive auto-name: the non-default axes, by their branch names."""
    arrs = as_policy_arrays(pol)
    parts = []
    for f in policy_fields():
        v = arrs[f.name]
        if v.dim() or int(v) == f.default:
            continue
        parts.append(f.choice_name(int(v)) if f.choices
                     else f"{f.name}={int(v)}")
    return "/".join(parts) or "default"


def _is_pair(item, *, in_sequence: bool) -> bool:
    """A ``(name, item)`` pair (the reference's rule: at top level a
    ``(str, str)`` tuple is two items, inside a sequence it is a pair)."""
    return (isinstance(item, tuple) and len(item) == 2
            and isinstance(item[0], str)
            and (in_sequence or not isinstance(item[1], str)))


def _normalize(items, build_one, what: str) -> List[Tuple[str, Any]]:
    """-> [(name, obj)] from one item, a sequence, or (name, item) pairs."""
    if items is None:
        items = [None] if what == "policy" else []
    elif (_is_pair(items, in_sequence=False)
          or not isinstance(items, (list, tuple))):
        items = [items]
    out = []
    for item in items:
        if _is_pair(item, in_sequence=True):
            name, obj = item[0], build_one(item[1])[1]
        else:
            name, obj = build_one(item)
        out.append((name, obj))
    if not out:
        raise ValueError(f"Experiment needs at least one {what}")
    seen: dict = {}
    named = []
    for name, obj in out:
        n = seen.get(name, 0)
        seen[name] = n + 1
        named.append((f"{name}#{n}" if n else name, obj))
    return named


class Experiment:
    """A declarative simulation experiment: one scenario × policies × seeds.

    Parameters
    ----------
    scenarios:
        A registered scenario name, a ``scenarios.Scenario``, a raw
        ``SimSetup``, or a ``(name, any of those)`` pair — one of them.
    policies:
        One or a sequence of: a ``PolicyConfig``, a partial mapping of
        registered policy fields, or a ``(name, policy)`` pair.  ``None``
        runs the registered defaults.
    seeds:
        Optional ints; each policy is replicated per seed (its ``seed``
        field replaced), so ``P = len(policies) * len(seeds)``.
    device:
        Where the route-table build and the engine run; ``None`` = CUDA,
        which raises when no CUDA device is present.
    """

    def __init__(self, scenarios: Any, policies: Any = None,
                 seeds: Optional[Sequence[int]] = None, device=None,
                 failures: Any = None, ctrl: Any = None,
                 degradation: Any = None):
        for value, axis, item in ((failures, "failures", "item 5"),
                                  (ctrl, "ctrl", "item 6"),
                                  (degradation, "degradation", "item 7")):
            if value is not None:
                raise NotImplementedError(
                    f"Experiment({axis}=...) is not ported yet "
                    f"(ROADMAP queue 1 {item})")
        if (isinstance(scenarios, (list, tuple))
                and not _is_pair(scenarios, in_sequence=False)
                and len(scenarios) != 1):
            raise NotImplementedError(
                "several scenarios in one Experiment (the packed "
                "multi-topology grid) are not ported yet (ROADMAP queue 1 "
                "item 4); run one Experiment per scenario")
        self.device = resolve(device)
        self.scenarios: List[Tuple[str, SimSetup]] = _normalize(
            scenarios, lambda s: _build_scenario(s, self.device),
            "scenario")
        pols = _normalize(
            policies, lambda p: (_policy_label(p), p), "policy")
        if seeds is not None:
            seeds = list(seeds)
            if not seeds:
                raise ValueError("seeds must be non-empty when given")
            pols = [(f"{name}/s{seed}" if len(seeds) > 1 else name,
                     _with_seed(pol, seed))
                    for name, pol in pols for seed in seeds]
        self.policies: List[Tuple[str, Any]] = pols

    @property
    def scenario_names(self) -> List[str]:
        return [n for n, _ in self.scenarios]

    @property
    def policy_names(self) -> List[str]:
        return [n for n, _ in self.policies]

    def policy_arrays(self) -> dict:
        """Registry-ordered ``[P]`` int32 policy arrays on the device."""
        stacked = [as_policy_arrays(p) for _, p in self.policies]
        return lane_policies({k: torch.stack([s[k] for s in stacked])
                              for k in stacked[0]}, device=self.device)

    def run(self) -> Results:
        """Run every policy as one lane of one engine loop."""
        consts, meta = make_consts(self.scenarios[0][1], self.device)
        states = make_packed_simulator(meta)(consts, self.policy_arrays())
        return Results(states=states, consts=consts, meta=meta,
                       scenario_names=self.scenario_names,
                       policy_names=self.policy_names)

    def run_fleet(self, *args, **kw):
        raise NotImplementedError(
            "run_fleet is not ported yet (ROADMAP queue 1 item 8); run() "
            "already runs the policies as lanes of one loop")

    def run_stream(self, *args, **kw):
        raise NotImplementedError(
            "run_stream is not ported yet (ROADMAP queue 1 item 9)")


def _with_seed(pol, seed: int):
    """A copy of ``pol`` with its ``seed`` policy field replaced."""
    if pol is None:
        return policy_mod.PolicyConfig(seed=seed)
    if isinstance(pol, Mapping):
        return {**pol, "seed": seed}
    return pol.replace(seed=seed)
