"""Runner cache: one engine runner per (SimMeta, batch kind), shared by
every entry point (DESIGN.md §6).

Port of ``src/repro/api/runners.py``.  The reference caches a jitted
program per key; here a runner is the engine loop built by
``make_packed_simulator`` for that ``SimMeta`` plus the batch kind's
layout, kept under the same LRU bound.  ``build_count`` counts the
engine programs built (the reference's ``trace_count`` counts its
traces): a second run with an equal ``SimMeta`` builds nothing.
``traced_ops`` (the reference's ``traced_jaxpr``) runs a program's first
events under the op recorder of ``analysis.op_walk`` for torchcheck,
touching neither the cache nor the counter.  The reference's
``donation_argnums`` has no counterpart: PyTorch has no buffer donation
(the engine's loop advances its carry without keeping a second copy).

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
fleet runs the same slices.  Its runner keeps the host-clock seconds of
each scenario's loop in the last call as ``seconds`` (a loop ends on a
host copy of its finished flags, so its device work is done by then).
"zipped" runs one one-lane loop per replica.

The fleet (``api.fleet``) and the streaming ring (``api.stream``) keep
their programs in the same cache, keyed as the reference keys them, so a
second ``run_fleet`` or ``run_stream`` with an equal ``SimMeta`` adds no
entry:

=====================================  ===================================
key                                    program
=====================================  ===================================
("fleet", meta, sig, K, W)             ``make_fleet_chunk``: K events of a
                                       W-lane cohort of static signature
                                       ``sig`` (routing, traffic,
                                       placement)
("fleet-init", meta, W)                ``init_fleet_carry``: the t=0 carry
("fleet-refill", meta, W)              ``tree_select``: refilled lanes
                                       back to the t=0 carry
("stream", meta, sig, K, W)            the chunk over per-lane streamed
                                       consts (``STREAM_FIELDS``)
("stream-init", meta, W)               the ring's t=0 carry
("stream-refill", meta, W)             ``streaming.make_refill``: the
                                       masked slot reset
=====================================  ===================================
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

import torch

from ..core.engine import (EngineConsts, SimState, _advance, _carry,
                           _make_aux, init_state_from_consts, lane_policies,
                           make_packed_simulator)
from ..core.simmeta import SimMeta
from ..scenarios.sweep import slice_packed

KINDS = ("single", "policy_batch", "zipped", "grid")

# LRU-bounded, as the reference's: callers like a roofline advisor build a
# fresh SimMeta per candidate schedule
CACHE_MAX = 64
_CACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()
_BUILD_COUNT = 0


def build_count() -> int:
    """Engine programs built since import (or the last ``cache_clear``)."""
    return _BUILD_COUNT


def note_build() -> None:
    """Bump the build counter: called by each cached program's builder,
    so cache hits don't count."""
    global _BUILD_COUNT
    _BUILD_COUNT += 1


def cache_size() -> int:
    return len(_CACHE)


def cache_clear() -> None:
    """Drop every cached runner and reset the build counter."""
    global _BUILD_COUNT
    _CACHE.clear()
    _BUILD_COUNT = 0


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


def traced_ops(meta: SimMeta, consts: EngineConsts, pols, events: int):
    """Static-analysis hook: the engine loop exactly as ``get_runner``
    builds it for "single" (or "policy_batch", when ``pols`` holds [P]
    values: one loop whose lanes are the policies), its first ``events``
    events run under an ``analysis.op_walk.OpRecorder``.  Returns ``(ops,
    carry, events run)`` where ``carry = (s, cache, nc, done)`` is the
    loop's carry after them.  Neither the program cache nor the build
    counter is touched.  The "zipped" and "grid" kinds run this loop once
    per replica or scenario."""
    from ..analysis.op_walk import OpRecorder
    pol = lane_policies(pols, device=consts.link_bw.device)
    width = pol["seed"].shape[0]
    # torchcheck: disable=item-call: the policies on the host, once a run
    ph = {k: v.cpu().numpy() for k, v in pol.items()}
    s = init_state_from_consts(consts, meta.n_switches, meta.ctrl_slots,
                               meta.spec_slots, width)
    aux = _make_aux(consts, meta, pol, ph)
    carry = _carry(consts, meta, s)
    rec = OpRecorder()
    with rec:
        carry = _advance(consts, meta, pol, ph, aux, carry, events)
    # torchcheck: disable=tracer-cast: after the recorded events
    return rec.ops, carry, min(events, int(carry[0].steps.max()))


def _stack(states: List[SimState]) -> SimState:
    return SimState(*(torch.stack(leaves) for leaves in zip(*states)))


def _build(meta: SimMeta, kind: str) -> Callable:
    note_build()
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
