"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``ref``, on the CPU), at the timed sizes.

After the window the run draws, from its seed, one of the experiments it
completed and, of each policy combination of the traffic's grid,
``check.per_combo`` of its lanes (their policy seeds drawn from the run's
seed), so that every combination is compared in every run.  The
reference builds the fabric, the routes, the jobs and the lanes itself
from the same configuration and the same generator numbers, runs those
lanes from t = 0, and reports them; lanes are independent, so a sampled
lane's final state is the one the whole batch gave it.  The numbers
compared, each against the limit the traffic file gives it
(``check.limits``):

- ``route_diff``: links (ends) and candidate routes (routes, counts,
  lengths, the table's sizes) that differ;
- ``int_diff``: integer and flag elements of the sampled lanes' final
  states that differ (event counts, task and packet states, placements,
  route picks, delivered counts);
- ``float_gap``: the widest gap of a float leaf of those states (clock,
  start and finish instants, remaining work, energy) and of the links'
  bandwidths, each leaf against its own scale;
- ``report_gap``: the same over the Eqs. 6-9 job report and the energy
  report of those lanes.

A leaf's gap is its largest absolute difference over its largest
reference magnitude (remaining work: over the largest packet or task,
since it ends near zero); NaN and infinities have to sit where the
reference has them, or the gap reads ``inf``.  The worst leaf of each gap
is logged.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from . import traffic as gen
from .ref import sim

CHECK_DRAW = 1 << 40      # the experiment index of the check's own draws

# the final-state leaves the reference gives, by the program's names
LEAVES = ("time", "steps", "stalled", "place_counter", "job_admitted",
          "job_admit_t", "job_out_done", "job_done_t", "task_state",
          "task_rem", "task_got", "task_vm", "task_start", "task_finish",
          "pkt_state", "pkt_rem", "pkt_pair", "pkt_cand", "pkt_start",
          "pkt_finish", "vm_load", "host_energy", "host_busy",
          "switch_energy")
TABLE = ("routes", "n_cand", "route_len", "max_hops", "k_max", "n_nodes",
         "truncated")


def leaf_gap(got, want, scale: float = 0.0) -> float:
    """``max |got - want| / max(max |want|, scale)`` over a leaf's finite
    elements (see above); 0 for equal leaves."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    fin = np.isfinite(want)
    if (fin != np.isfinite(got)).any() or \
            (~fin & ~(np.isnan(got) & np.isnan(want)) & (got != want)).any():
        return math.inf
    if not fin.any():
        return 0.0
    diff = float(np.abs(got[fin] - want[fin]).max())
    if diff == 0.0:
        return 0.0
    scale = max(float(np.abs(want[fin]).max()), scale)
    return diff / scale if scale > 0 else math.inf


def _worst(pairs, worst: dict, key: str, scales=None) -> float:
    """The largest ``leaf_gap`` of ``(name, got, want)`` triples, each
    leaf against ``scales[name]`` too where given; its leaf's name goes to
    ``worst[key]``."""
    scales = scales or {}
    gap, worst[key] = max(((leaf_gap(g, w, scales.get(n, 0.0)), n)
                           for n, g, w in pairs),
                          key=lambda x: x[0], default=(0.0, None))
    return gap


def diff_count(got, want) -> int:
    """Elements that differ; every element when the shapes do."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return max(got.size, want.size, 1)
    return int((got != want).sum())


def route_numbers(got_topo, got_rt, want_topo, want_rt) -> Dict[str, float]:
    """``route_diff`` of a fabric and its route table against the
    reference's (both expose ``link_src``, ``link_dst`` and the table's
    fields by these names)."""
    n = sum(diff_count(getattr(got_topo, f), getattr(want_topo, f))
            for f in ("link_src", "link_dst"))
    n += sum(diff_count(getattr(got_rt, f), getattr(want_rt, f))
             for f in TABLE)
    return {"route_diff": int(n)}


def state_numbers(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  worst: dict, scales=None) -> Dict[str, float]:
    """``int_diff`` and ``float_gap`` over every leaf of ``want`` (leaves
    ``[lanes, ...]``), each float leaf against ``scales`` too."""
    ints = sum(diff_count(got[n], w) for n, w in want.items()
               if not np.issubdtype(np.asarray(w).dtype, np.floating))
    gap = _worst(((n, got[n], w) for n, w in want.items()
                  if np.issubdtype(np.asarray(w).dtype, np.floating)),
                 worst, "float_gap", scales)
    return {"int_diff": ints, "float_gap": gap}


def report_numbers(got: Tuple[dict, dict], want: Tuple[dict, dict],
                   worst: dict) -> Dict[str, float]:
    pairs = ((k, g[k], v) for g, w in zip(got, want) for k, v in w.items())
    return {"report_gap": _worst(pairs, worst, "report_gap")}


def sample_lanes(traffic: dict, seed: int) -> List[int]:
    """The lanes the reference re-runs: ``check.per_combo`` policy seeds
    of each combination of the grid, drawn from the run's seed; sorted."""
    spec = traffic["lanes"]
    n_combo = int(np.prod([len(v) for v in spec["axes"].values()]))
    n_seeds = spec.get("seeds", 1)
    per = min(traffic["check"]["per_combo"], n_seeds)
    rng = gen.experiment_rng(seed, CHECK_DRAW)
    return sorted(int(s) * n_combo + c for c in range(n_combo)
                  for s in rng.choice(n_seeds, size=per, replace=False))


def program_view(outcome, traffic: dict, seed: int) -> dict:
    """What the check reads of the program's sampled experiment, on the
    host, so that its device state can be freed first."""
    import torch
    lanes = sample_lanes(traffic, seed)
    states = outcome.result.states
    idx = torch.as_tensor(lanes, device=states.time.device)
    return {"k": outcome.k, "lanes": lanes,
            "states": {n: getattr(states, n)[0, idx].cpu().numpy()
                       for n in LEAVES},
            "report": tuple({k: v[0, lanes] for k, v in part.items()}
                            for part in outcome.report)}


def reference_view(config: dict, traffic: dict, seed: int, k: int,
                   lanes: List[int], fabric=None, lower: bool = False
                   ) -> dict:
    """The reference's run of experiment ``k``'s ``lanes`` (``fabric``:
    its fabric and routes, built once; ``lower``: the control)."""
    world = sim.build_world(config, gen.job_order(config, seed, k), fabric,
                            lower)
    grid = gen.lanes(traffic)
    outs = [sim.run_lane(world, sim.policy(grid[i])) for i in lanes]
    reps = [sim.report(world, o) for o in outs]
    return {"k": k, "lanes": lanes, "world": world,
            "states": {n: np.stack([np.asarray(o[n]) for o in outs])
                       for n in LEAVES},
            "report": tuple({n: np.stack([np.asarray(r[i][n]) for r in reps])
                             for n in reps[0][i]} for i in (0, 1))}


def numbers(got: dict, want: dict, got_tables, worst: dict = None
            ) -> Dict[str, float]:
    """Every number of the check: ``got`` (a ``program_view``, or the
    control's ``reference_view``) with its ``(fabric, route table)``
    against the reference's view ``want``.  ``worst`` gets each gap's
    worst leaf."""
    worst = {} if worst is None else worst
    w = want["world"]
    nums = route_numbers(*got_tables, w.fabric, w.routes)
    g_states = dict(got["states"], link_bw=got_tables[0].link_bw)
    w_states = dict(want["states"], link_bw=w.fabric.link_bw)
    scales = {"pkt_rem": float(w.pkt_bits.max()),
              "task_rem": float(w.task_mi.max())}
    nums.update(state_numbers(g_states, w_states, worst, scales))
    nums.update(report_numbers(got["report"], want["report"], worst))
    return nums


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})``: correct when every
    number is at or under its limit (NaN never is)."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
