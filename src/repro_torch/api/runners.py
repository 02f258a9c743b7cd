"""Runner cache: one engine runner per (SimMeta, batch kind), shared by
every entry point (DESIGN.md §6).

Port of ``src/repro/api/runners.py``.  The reference caches a jitted
program per key; here a runner is the engine loop built by
``make_packed_simulator`` for that ``SimMeta`` plus the batch kind's
layout, kept under the same LRU bound.  The reference's ``trace_count``,
``note_trace``, ``traced_jaxpr`` and ``donation_argnums`` describe JAX
tracing and buffer donation and have no counterpart in PyTorch (ROADMAP
queue 1 item 12).

Batch kinds (all funnel into ``make_packed_simulator``'s ``run(consts,
pol)``, whose policies are lanes of one loop):

==============  =============================  ==========================
kind            consts                         policies
==============  =============================  ==========================
"single"        unbatched                      unbatched dict
"policy_batch"  unbatched (shared)             leading policy dim [P]
"zipped"        leading replica dim [R]        leading replica dim [R]
"grid"          leading scenario dim [S]       leading policy dim [P]
==============  =============================  ==========================

"grid" runs one loop per scenario over ``slice_packed(consts, si)``
under the packed ``SimMeta``, its policies as lanes, and stacks the
final states into ``[S, P, ...]`` — bit-exact by construction, as the
reference's fleet layer runs the same slices.  Its runner keeps the
host-clock seconds of each scenario's loop in the last call as
``seconds`` (a loop ends on a host copy of its finished flags, so its
device work is done by then).  "zipped" runs one one-lane loop per
replica.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

import torch

from ..core.engine import (EngineConsts, SimState, lane_policies,
                           make_packed_simulator)
from ..core.simmeta import SimMeta
from ..scenarios.sweep import slice_packed

KINDS = ("single", "policy_batch", "zipped", "grid")

# LRU-bounded, as the reference's: callers like a roofline advisor build a
# fresh SimMeta per candidate schedule
CACHE_MAX = 64
_CACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()


def cache_size() -> int:
    return len(_CACHE)


def cache_clear() -> None:
    """Drop every cached runner."""
    _CACHE.clear()


def get_cached_program(key: Tuple, builder: Callable[[], Callable]
                       ) -> Callable:
    """The shared cache: ``builder()`` runs at most once per ``key``
    (hashable tuple), its result LRU-retained up to ``CACHE_MAX``
    entries."""
    if key not in _CACHE:
        _CACHE[key] = builder()
        while len(_CACHE) > CACHE_MAX:
            _CACHE.popitem(last=False)
    _CACHE.move_to_end(key)
    return _CACHE[key]


def get_runner(meta: SimMeta, kind: str) -> Callable:
    """The cached ``run(consts, pols) -> SimState`` for this meta and
    batch kind; the final state's leaves take the kind's layout."""
    if kind not in KINDS:
        raise ValueError(f"unknown runner kind {kind!r}; one of {KINDS}")
    return get_cached_program((meta, kind), lambda: _build(meta, kind))


def _stack(states: List[SimState]) -> SimState:
    return SimState(*(torch.stack(leaves) for leaves in zip(*states)))


def _build(meta: SimMeta, kind: str) -> Callable:
    base = make_packed_simulator(meta)

    def lanes(consts: EngineConsts, pols: Dict[str, torch.Tensor]
              ) -> SimState:
        return base(consts, lane_policies(pols, device=consts.link_bw.device))

    if kind == "single":
        def run(consts, pol):
            return SimState(*(leaf[0] for leaf in lanes(consts, pol)))
    elif kind == "policy_batch":
        run = lanes
    elif kind == "zipped":
        def run(consts, pols):
            n = consts.link_bw.shape[0]
            return _stack([SimState(*(leaf[0] for leaf in lanes(
                slice_packed(consts, r), {k: v[r:r + 1]
                                          for k, v in pols.items()})))
                for r in range(n)])
    else:  # grid: one loop per scenario, policies as its lanes
        def run(consts, pols):
            states, run.seconds = [], []
            for si in range(consts.link_bw.shape[0]):
                t0 = time.perf_counter()
                states.append(lanes(slice_packed(consts, si), pols))
                run.seconds.append(time.perf_counter() - t0)
            return _stack(states)
        run.seconds = []
    return run
