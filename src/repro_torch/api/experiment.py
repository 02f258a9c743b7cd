"""``Experiment`` — the front door for running simulations (DESIGN.md §6).

Port of ``src/repro/api/experiment.py``::

    Experiment(scenarios="paper-fabric",
               policies=[("sdn", PolicyConfig(routing=ROUTE_SDN)),
                         ("legacy", PolicyConfig(routing=ROUTE_LEGACY))],
               seeds=range(3), device="cuda").run()

covers a single run, a policy batch on one fabric (every policy × seed a
lane of one engine loop) and a packed heterogeneous multi-topology grid
(one loop per scenario, ``api.runners``), with the failure, gray-failure
and control-plane axes crossing every scenario with every schedule or
config, on ``device`` (``None`` = CUDA), and returns a ``Results`` grid
``[S, P, ...]``.  ``run_fleet`` drains the same grid through the fleet's
chunked cohorts (``api.fleet``, DESIGN.md §9) and ``run_stream`` streams an
open arrival process through one scenario's slot-recycling ring
(``api.stream``, DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

from ..core import policies as policy_mod
from ..core.ctrlplane import CtrlPlaneConfig
from ..core.engine import SimState, lane_policies, make_consts
from ..core.failures import DegradationSchedule, FailureSchedule
from ..core.mapreduce import SimSetup
from ..core.policies import as_policy_arrays, policy_fields
from ..device import resolve
from . import runners
from .results import Results

# Keyed caches: registry scenarios build deterministically from their
# name, so the host-side lowering (route-table DFS + the hop-distance
# kernel + packing) is paid once per process and device, not once per
# Experiment.  Only registry-name scenarios are cacheable; Scenario
# objects / raw SimSetups may differ run to run under the same name, and
# failure, degradation and ctrl crosses replace the setups' schedules and
# configs after the build.
_SETUP_CACHE: "OrderedDict[Tuple[str, str], Tuple[str, SimSetup]]" = \
    OrderedDict()
_CONSTS_CACHE: "OrderedDict[Tuple, Any]" = OrderedDict()
_CACHE_MAX = 16
_CONSTS_BUILDS = 0


def consts_build_count() -> int:
    """Number of EngineConsts builds (make_consts/pack_setups) since import
    or the last ``consts_cache_clear``."""
    return _CONSTS_BUILDS


def consts_cache_clear() -> None:
    """Drop cached setups/consts and zero ``consts_build_count``."""
    global _CONSTS_BUILDS
    _SETUP_CACHE.clear()
    _CONSTS_CACHE.clear()
    _CONSTS_BUILDS = 0


def _lru_put(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    while len(cache) > _CACHE_MAX:
        cache.popitem(last=False)


def _build_scenario(item, device) -> Tuple[str, SimSetup]:
    """-> (name, SimSetup) from a registry name, Scenario, or SimSetup.
    Registry names are memoized per device in ``_SETUP_CACHE``."""
    if isinstance(item, str):
        key = (item, str(device))
        if key in _SETUP_CACHE:
            _SETUP_CACHE.move_to_end(key)
            return _SETUP_CACHE[key]
        from ..scenarios import get_scenario
        sc = get_scenario(item)
        built = (sc.name, sc.build(device))
        _lru_put(_SETUP_CACHE, key, built)
        return built
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
    """A declarative simulation experiment: scenarios × policies × seeds.

    Parameters
    ----------
    scenarios:
        One or a sequence of: a registered scenario name, a
        ``scenarios.Scenario``, a raw ``SimSetup``, or a ``(name, any of
        those)`` pair.  (A TOP-LEVEL ``(str, str)`` tuple is read as two
        scenario names; wrap it in a list to mean a named pair.)  Several
        scenarios are padded + renumbered into one packed batch.
    policies:
        One or a sequence of: a ``PolicyConfig``, a partial mapping of
        registered policy fields, or a ``(name, policy)`` pair.  ``None``
        runs the registered defaults.
    seeds:
        Optional ints; each policy is replicated per seed (its ``seed``
        field replaced), so ``P = len(policies) * len(seeds)``.
    failures:
        Optional failure schedules (DESIGN.md §7).  One or a sequence of:
        a ``FailureSchedule``, a callable ``(SimSetup) -> FailureSchedule``
        (e.g. ``scenarios.failures.failure_injector``), or a ``(name,
        either)`` pair.  Each scenario is replicated per schedule, so
        ``S = len(scenarios) * len(failures)``; the replicas share their
        base setup's route table.
    ctrl:
        Optional control-plane configs (DESIGN.md §10).  One or a sequence
        of: a ``CtrlPlaneConfig`` or a ``(name, config)`` pair.  Each
        scenario is replicated per config.
    degradation:
        Optional gray-failure schedules (DESIGN.md §13).  One or a
        sequence of: a ``DegradationSchedule``, a callable ``(SimSetup) ->
        DegradationSchedule`` (e.g. ``scenarios.failures.
        degradation_injector``), or a ``(name, either)`` pair.  Each
        scenario is replicated per schedule.  The crosses compose as the
        reference's: failures, then degradation, then ctrl.
    device:
        Keyword only.  Where the route-table build and the engine run;
        ``None`` = CUDA, which raises when no CUDA device is present.
    """

    def __init__(self, scenarios: Any, policies: Any = None,
                 seeds: Optional[Sequence[int]] = None,
                 failures: Any = None, ctrl: Any = None,
                 degradation: Any = None, *, device=None):
        self.device = resolve(device)
        # consts are cacheable across Experiments only when every scenario
        # is a bare registry name and no cross replaces schedules/configs
        items = (list(scenarios)
                 if isinstance(scenarios, (list, tuple))
                 and not _is_pair(scenarios, in_sequence=False)
                 else [scenarios])
        self._consts_key = (tuple(items) + (str(self.device),)
                            if failures is None and ctrl is None
                            and degradation is None
                            and all(isinstance(i, str) for i in items)
                            else None)
        self.scenarios: List[Tuple[str, SimSetup]] = _normalize(
            scenarios, lambda s: _build_scenario(s, self.device),
            "scenario")
        if failures is not None:
            self.scenarios = _cross_failures(self.scenarios, failures)
        if degradation is not None:
            self.scenarios = _cross_degradation(self.scenarios, degradation)
        if ctrl is not None:
            self.scenarios = _cross_ctrl(self.scenarios, ctrl)
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
        # the grid is immutable after __init__: build once
        self._built = None
        self._pol_arrays = None

    @property
    def scenario_names(self) -> List[str]:
        return [n for n, _ in self.scenarios]

    @property
    def policy_names(self) -> List[str]:
        return [n for n, _ in self.policies]

    def build(self):
        """-> (consts, SimMeta) on the device: unpacked for one scenario,
        packed (leading scenario dim) for several.  Memoized per instance
        and, for registry-name scenario sets without a cross, in
        the process-wide consts cache keyed by the names and the device
        (``consts_build_count``)."""
        if self._built is None:
            key = self._consts_key
            if key is not None and key in _CONSTS_CACHE:
                _CONSTS_CACHE.move_to_end(key)
                self._built = _CONSTS_CACHE[key]
                return self._built
            global _CONSTS_BUILDS
            _CONSTS_BUILDS += 1
            if len(self.scenarios) == 1:
                self._built = make_consts(self.scenarios[0][1], self.device)
            else:
                from ..scenarios.sweep import pack_setups
                self._built = pack_setups([s for _, s in self.scenarios],
                                          self.device)
            if key is not None:
                _lru_put(_CONSTS_CACHE, key, self._built)
        return self._built

    def policy_arrays(self) -> dict:
        """Registry-ordered ``[P]`` int32 policy arrays on the device
        (memoized)."""
        if self._pol_arrays is None:
            stacked = [as_policy_arrays(p) for _, p in self.policies]
            self._pol_arrays = lane_policies(
                {k: torch.stack([s[k] for s in stacked])
                 for k in stacked[0]}, device=self.device)
        return self._pol_arrays

    def run(self) -> Results:
        """Execute the whole grid through the runner cache: one scenario
        runs its policies as lanes of one loop; several run one loop per
        scenario over the packed consts."""
        S, P = len(self.scenarios), len(self.policies)
        consts, meta = self.build()
        pols = self.policy_arrays()
        if S == 1 and P == 1:
            states = runners.get_runner(meta, "single")(
                consts, {k: v[0] for k, v in pols.items()})
            states = SimState(*(a[None, None] for a in states))
        elif S == 1:
            states = runners.get_runner(meta, "policy_batch")(consts, pols)
            states = SimState(*(a[None] for a in states))
        else:
            states = runners.get_runner(meta, "grid")(consts, pols)
        if S == 1:   # Results keeps a scenario axis on consts
            consts = type(consts)(*(a[None] for a in consts))
        return Results(states=states, consts=consts, meta=meta,
                       scenario_names=self.scenario_names,
                       policy_names=self.policy_names)

    def run_fleet(self, width: int = 32, chunk_steps: int = 32,
                  **kw) -> Results:
        """Execute the grid through the fleet engine (DESIGN.md §9):
        chunked early-exit cohorts grouped by static policy signature, on
        one device.  Bit-identical to ``run()``.  Extra keywords pass
        through to ``fleet.run_fleet``."""
        from .fleet import run_fleet
        return run_fleet(self, width=width, chunk_steps=chunk_steps, **kw)

    def run_stream(self, arrivals, horizon: float, *, warmup: float = 0.0,
                   window: Optional[float] = None, slots: int = 32,
                   chunk_steps: int = 128, **kw):
        """Stream an open arrival process through the experiment's (single)
        scenario for every policy (DESIGN.md §11): the job/task/packet
        tensors become a ``slots``-deep recycling ring refilled from
        ``arrivals`` (``repro_torch.scenarios.arrivals``) at chunk
        boundaries, so an unbounded trace runs in bounded memory.  Returns
        a ``StreamResults`` with per-window p50/p99 sojourn, throughput,
        utilization, energy, and per-class SLO attainment; completions
        before ``warmup`` are excluded from ``summary()``.  A finite trace
        that fits ``slots`` reproduces ``run()`` on the equivalent
        ``streaming.ring_setup`` bit for bit.  Extra keywords pass through
        to ``stream.run_stream``."""
        from .stream import run_stream
        return run_stream(self, arrivals, horizon, warmup=warmup,
                          window=window, slots=slots,
                          chunk_steps=chunk_steps, **kw)


def _cross_failures(scenarios: List[Tuple[str, SimSetup]],
                    failures: Any) -> List[Tuple[str, SimSetup]]:
    """Replicate every scenario per failure schedule (names suffixed with
    the schedule label when there is more than one)."""
    if isinstance(failures, FailureSchedule) or callable(failures) \
            or _is_pair(failures, in_sequence=False):
        failures = [failures]
    named = []
    for fi, item in enumerate(failures):
        if _is_pair(item, in_sequence=True):
            fname, spec = item
        else:
            fname, spec = f"f{fi}", item
        named.append((fname, spec))
    out = []
    for sname, setup in scenarios:
        for fname, spec in named:
            sched = spec(setup) if callable(spec) else spec
            if not isinstance(sched, FailureSchedule):
                raise TypeError(
                    f"cannot interpret {type(sched).__name__} as a "
                    "FailureSchedule")
            topo = setup.cluster.topo
            sched.validate(topo.n_hosts, topo.n_links)
            name = f"{sname}/{fname}" if len(named) > 1 else sname
            out.append((name, dataclasses.replace(setup, failures=sched)))
    return out


def _cross_degradation(scenarios: List[Tuple[str, SimSetup]],
                       degradation: Any) -> List[Tuple[str, SimSetup]]:
    """Replicate every scenario per degradation schedule (names suffixed
    with the schedule label when there is more than one)."""
    if isinstance(degradation, DegradationSchedule) \
            or callable(degradation) \
            or _is_pair(degradation, in_sequence=False):
        degradation = [degradation]
    named = []
    for di, item in enumerate(degradation):
        if _is_pair(item, in_sequence=True):
            dname, spec = item
        else:
            dname, spec = f"d{di}", item
        named.append((dname, spec))
    out = []
    for sname, setup in scenarios:
        for dname, spec in named:
            sched = spec(setup) if callable(spec) else spec
            if not isinstance(sched, DegradationSchedule):
                raise TypeError(
                    f"cannot interpret {type(sched).__name__} as a "
                    "DegradationSchedule")
            topo = setup.cluster.topo
            sched.validate(topo.n_hosts, topo.n_links)
            name = f"{sname}/{dname}" if len(named) > 1 else sname
            out.append((name, dataclasses.replace(setup,
                                                  degradation=sched)))
    return out


def _cross_ctrl(scenarios: List[Tuple[str, SimSetup]],
                ctrl: Any) -> List[Tuple[str, SimSetup]]:
    """Replicate every scenario per control-plane config (names suffixed
    with the config label when there is more than one)."""
    if isinstance(ctrl, CtrlPlaneConfig) \
            or _is_pair(ctrl, in_sequence=False):
        ctrl = [ctrl]
    named = []
    for ci, item in enumerate(ctrl):
        if _is_pair(item, in_sequence=True):
            cname, cfg = item
        else:
            cname, cfg = f"c{ci}", item
        if not isinstance(cfg, CtrlPlaneConfig):
            raise TypeError(
                f"cannot interpret {type(cfg).__name__} as a "
                "CtrlPlaneConfig")
        named.append((cname, cfg.validate()))
    out = []
    for sname, setup in scenarios:
        for cname, cfg in named:
            name = f"{sname}/{cname}" if len(named) > 1 else sname
            out.append((name, dataclasses.replace(setup, ctrl=cfg)))
    return out


def _with_seed(pol, seed: int):
    """A copy of ``pol`` with its ``seed`` policy field replaced."""
    if pol is None:
        return policy_mod.PolicyConfig(seed=seed)
    if isinstance(pol, Mapping):
        return {**pol, "seed": seed}
    return pol.replace(seed=seed)
