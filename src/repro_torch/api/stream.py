"""Streaming execution: ``Experiment.run_stream`` (DESIGN.md §11).

Port of ``src/repro/api/stream.py``.  Drives the slot-recycling ring
(``core.streaming``) with the fleet's chunked cohort machinery (DESIGN.md
§9): policies group by static signature into cohorts, each lane runs the
SAME arrival trace under its own policy, and between K-event chunks the
host retires completed job slots, records their sojourn, and refills the
freed slots from the trace.  Tensor shapes never change, so an arbitrarily
long trace runs through one chunk program in bounded memory.

``StreamResults`` is the windowed-metrics surface: per-window p50/p99
sojourn, throughput, utilization, energy, and per-class SLO attainment
(windows with no completions are NaN, like the pad-job masking in
``Results.job_report``), plus warmup-excluded steady-state summaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.engine import init_fleet_carry, make_consts, make_fleet_chunk
from ..core.simmeta import SimMeta
from ..core.streaming import (RingSpec, STREAM_FIELDS, host_stream_arrays,
                              load_slot, make_refill, ring_setup)
from . import runners
from .fleet import (STATIC_FIELDS, CohortSchedule, _group_by_signature,
                    _lane_policies)


@dataclasses.dataclass
class StreamStats:
    """What the streaming run actually did (conservation surface: every
    arrival is loaded exactly once and retired exactly once per lane)."""

    lanes: int = 0       # policy members across cohorts
    cohorts: int = 0     # static-signature groups
    chunks: int = 0      # K-step chunk invocations
    loads: int = 0       # slot loads (initial fill + refills), all lanes
    refills: int = 0     # slot loads AFTER the initial fill, all lanes
    retired: int = 0     # job completions recorded, all lanes
    trace_len: int = 0   # arrivals materialized below the horizon
    slots: int = 0       # ring capacity (jobs resident per lane)


def _percentile(a: np.ndarray, q: float) -> float:
    a = a[np.isfinite(a)]
    return float(np.percentile(a, q)) if a.size else float("nan")


@dataclasses.dataclass
class StreamResults:
    """Windowed streaming metrics for one scenario × P policies.

    ``jobs[pi]`` holds one row per completed job (arrays over jobs):
    ``seq`` (arrival index), ``cls`` (service-class index), ``t_arr``,
    ``t_admit``, ``t_done`` and ``sojourn = t_done - t_arr`` (arrival to
    completion, host queueing included).  ``samples[pi]`` is a ``[K, 4]``
    array of cumulative ``(time, host_energy, switch_energy, host_busy)``
    at chunk boundaries — utilization/energy windows interpolate it, so
    their resolution is the chunk cadence, not per-event."""

    scenario_name: str
    policy_names: List[str]
    classes: Tuple[Any, ...]          # arrivals.ServiceClass tuple
    horizon: float
    warmup: float
    window_s: float
    meta: SimMeta
    jobs: Dict[int, Dict[str, np.ndarray]]
    samples: Dict[int, np.ndarray]
    stats: StreamStats
    final_states: Optional[Dict[int, Any]] = None
    final_consts: Optional[Dict[int, Any]] = None
    # per-policy cumulative chaos counters at drain (DESIGN.md §13):
    # spec_launches / spec_wins / wasted_spec_work_s / degraded_time_s /
    # failover_count / failover_park_s — zero when those features are off
    chaos: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def n_policies(self) -> int:
        return len(self.policy_names)

    def windows(self, policy: int = 0) -> Dict[str, np.ndarray]:
        """Per-window metrics (windows of ``window_s`` from t=0, covering
        every completion): ``t0``/``t1``, ``n_done``, ``throughput_jobs_s``,
        ``p50_sojourn_s``/``p99_sojourn_s``, ``utilization``, ``energy_j``,
        and ``slo_attainment`` as ``[n_classes, n_windows]`` — empty
        windows / empty classes are NaN."""
        j = self.jobs[policy]
        w = self.window_s
        # torchcheck: disable=tracer-cast: numpy on the host
        t_hi = max(self.horizon,
                   float(j["t_done"].max()) if j["t_done"].size else 0.0)
        n_w = max(1, int(math.ceil(t_hi / w)))
        edges = np.arange(n_w + 1) * w
        idx = np.clip((j["t_done"] // w).astype(int), 0, n_w - 1)
        n_done = np.bincount(idx, minlength=n_w)[:n_w] \
            if j["t_done"].size else np.zeros(n_w, int)
        p50 = np.full(n_w, np.nan)
        p99 = np.full(n_w, np.nan)
        attain = np.full((len(self.classes), n_w), np.nan)
        for k in range(n_w):
            sel = idx == k if j["t_done"].size else np.zeros(0, bool)
            soj = j["sojourn"][sel]
            if soj.size:
                p50[k] = _percentile(soj, 50)
                p99[k] = _percentile(soj, 99)
            for ci, cl in enumerate(self.classes):
                cs = soj[j["cls"][sel] == ci]
                if cs.size:
                    attain[ci, k] = float(np.mean(cs <= cl.slo_s))
        # cumulative boundary samples -> per-window deltas (NaN before the
        # first / after the last sample of the lane's run)
        smp = self.samples[policy]
        ts, he, se, hb = smp.T
        energy = np.interp(edges, ts, he + se, left=0.0, right=(he + se)[-1])
        busy = np.interp(edges, ts, hb, left=0.0, right=hb[-1])
        util = np.diff(busy) / (int(self.meta.n_hosts) * w)
        return {
            "t0": edges[:-1], "t1": edges[1:],
            "n_done": n_done,
            "throughput_jobs_s": n_done / w,
            "p50_sojourn_s": p50, "p99_sojourn_s": p99,
            "utilization": util,
            "energy_j": np.diff(energy),
            "slo_attainment": attain,
        }

    def summary(self, policy: int = 0) -> Dict[str, Any]:
        """Warmup-excluded steady-state aggregates for one policy: jobs
        completing after ``warmup`` count; span = last completion −
        warmup."""
        j = self.jobs[policy]
        sel = j["t_done"] >= self.warmup
        soj = j["sojourn"][sel]
        # torchcheck: disable=tracer-cast: numpy on the host
        span = (float(j["t_done"].max()) - self.warmup
                if sel.any() else float("nan"))
        per_class = {}
        for ci, cl in enumerate(self.classes):
            cs = soj[j["cls"][sel] == ci]
            per_class[cl.name] = {
                "n": int(cs.size),
                "slo_s": float(cl.slo_s),
                "attainment": (float(np.mean(cs <= cl.slo_s))
                               if cs.size else float("nan")),
            }
        smp = self.samples[policy]
        # torchcheck: disable=tracer-cast: numpy on the host
        return {
            "policy": self.policy_names[policy],
            "jobs_done": int(sel.sum()),
            "span_s": span,
            "throughput_jobs_s": (float(sel.sum()) / span
                                  if span and span > 0 else float("nan")),
            "p50_sojourn_s": _percentile(soj, 50),
            "p99_sojourn_s": _percentile(soj, 99),
            "mean_sojourn_s": (float(soj.mean())
                               if soj.size else float("nan")),
            "energy_j": float(smp[-1, 1] + smp[-1, 2]),
            "classes": per_class,
            **self.chaos.get(policy, {}),
        }

    def rows(self) -> List[Dict[str, Any]]:
        """Flat per-(policy, window) rows — the CSV/JSON shape."""
        out = []
        for pi, pn in enumerate(self.policy_names):
            wd = self.windows(pi)
            for k in range(wd["t0"].size):
                row = {"policy": pn,
                       "t0": float(wd["t0"][k]), "t1": float(wd["t1"][k]),
                       "n_done": int(wd["n_done"][k]),
                       "throughput_jobs_s": float(
                           wd["throughput_jobs_s"][k]),
                       "p50_sojourn_s": float(wd["p50_sojourn_s"][k]),
                       "p99_sojourn_s": float(wd["p99_sojourn_s"][k]),
                       "utilization": float(wd["utilization"][k]),
                       "energy_j": float(wd["energy_j"][k])}
                for ci, cl in enumerate(self.classes):
                    row[f"slo_{cl.name}"] = float(
                        wd["slo_attainment"][ci, k])
                out.append(row)
        return out


def _stream_chunk(meta: SimMeta, sig, chunk_steps: int, width: int):
    def build():
        runners.note_build()
        return make_fleet_chunk(meta, dict(zip(STATIC_FIELDS, sig)),
                                chunk_steps, lane_fields=STREAM_FIELDS)
    return runners.get_cached_program(
        ("stream", meta, sig, chunk_steps, width), build)


def _stream_refill(meta: SimMeta, width: int):
    return runners.get_cached_program(("stream-refill", meta, width),
                                      lambda: make_refill(meta))


def _stream_init(meta: SimMeta, width: int):
    return runners.get_cached_program(
        ("stream-init", meta, width),
        lambda: lambda c: init_fleet_carry(c, meta, width))


def _upload(consts0, host, dev):
    """``consts0`` with the streamed leaves replaced by the host arrays'
    ``[W, ...]`` copies on ``dev``."""
    return consts0._replace(**{f: torch.from_numpy(host[f]).to(dev)
                               for f in STREAM_FIELDS})


def run_stream(exp, arrivals, horizon: float, *, warmup: float = 0.0,
               window: Optional[float] = None, slots: int = 32,
               chunk_steps: int = 128, split: int = 1,
               spec: Optional[RingSpec] = None,
               max_chunks: Optional[int] = None,
               return_states: bool = False) -> StreamResults:
    """Stream an open arrival process through ONE scenario for every policy
    of ``exp`` (see ``Experiment.run_stream``), on ``exp.device``.

    The trace is materialized below ``horizon`` once and shared by every
    lane; each lane consumes it at its own pace (its policy's pace).  The
    run continues PAST the horizon until every lane drains its ring: every
    arrival is accounted for, none is truncated."""
    if len(exp.scenarios) != 1:
        raise ValueError(
            f"run_stream streams one scenario per call "
            f"(got {len(exp.scenarios)}); packed scenario streaming would "
            "re-shape the job axis per scenario")
    sname, setup0 = exp.scenarios[0]
    trace = list(arrivals.events(horizon))
    if not trace:
        raise ValueError("arrival process produced no arrivals below the "
                         f"horizon ({horizon})")
    spec = spec or RingSpec.for_jobs([a.job for a in trace], slots=slots,
                                     split=split)
    for a in trace:
        spec.check(a.job)

    rs = ring_setup([a.job for a in trace[:spec.slots]], setup0.cluster,
                    spec, route_table=setup0.route_table,
                    failures=setup0.failures, ctrl=setup0.ctrl,
                    degradation=setup0.degradation,
                    spec_slots=setup0.spec_slots)
    dev = exp.device
    consts0, meta = make_consts(rs, dev)

    # torchcheck: disable=item-call: the policies on the host, once a stream
    pol_np = {k: v.cpu().numpy() for k, v in exp.policy_arrays().items()}
    P = len(exp.policies)
    groups = _group_by_signature(pol_np, P)

    n_slots, T, Pk = spec.slots, spec.tasks_per_slot, spec.pkts_per_slot
    window = window if window is not None else horizon / 20.0
    classes = tuple(getattr(arrivals, "classes", ()) or ())
    n_trace = len(trace)
    if max_chunks is None:
        gens = n_trace // n_slots + 2
        max_chunks = 64 + 4 * gens * (meta.max_steps // chunk_steps + 2)

    stats = StreamStats(lanes=P, trace_len=n_trace, slots=n_slots)
    job_rows: Dict[int, List[tuple]] = {pi: [] for pi in range(P)}
    samples: Dict[int, List[tuple]] = {pi: [(0.0, 0.0, 0.0, 0.0)]
                                       for pi in range(P)}
    finals: Dict[int, Any] = {}
    finals_c: Dict[int, Any] = {}
    chaos: Dict[int, Dict[str, float]] = {}

    for sig, members in groups.items():
        W = len(members)
        # fixed lane <-> member assignment: the CohortSchedule degenerates
        # to its lane map (streaming retires SLOTS, not lanes)
        sched = CohortSchedule(members, W)
        pol_lane = _lane_policies(pol_np, sched)
        chunk = _stream_chunk(meta, sig, chunk_steps, W)
        refill = _stream_refill(meta, W)
        host = host_stream_arrays(consts0, W)
        carry = _stream_init(meta, W)(consts0)
        stats.cohorts += 1
        stats.loads += min(n_slots, n_trace) * W

        occupants: List[List[Optional[int]]] = [
            [i if i < min(n_slots, n_trace) else None
             for i in range(n_slots)] for _ in range(W)]
        ptr = [min(n_slots, n_trace)] * W
        consts_dev = _upload(consts0, host, dev)

        def lane_live(li):
            return (ptr[li] < n_trace
                    or any(o is not None for o in occupants[li]))

        chunks = 0
        while any(lane_live(li) for li in range(W)):
            carry = chunk(consts_dev, pol_lane, carry)
            chunks += 1
            stats.chunks += 1
            if chunks > max_chunks:
                raise RuntimeError(
                    f"stream cohort {sig} exceeded {max_chunks} chunks "
                    "without draining — engine not making progress")
            s = carry[0]
            # torchcheck: disable=item-call: the ledger's reads at a chunk
            # boundary
            (done, t_arr, stalled, out_done, done_t, admit_t,
             he, se, hb) = (a.cpu().numpy() for a in (
                 carry[3], s.time, s.stalled, s.job_out_done, s.job_done_t,
                 s.job_admit_t, s.host_energy, s.switch_energy,
                 s.host_busy))
            job_m = np.zeros((W, n_slots), bool)
            task_m = np.zeros((W, n_slots * T), bool)
            pkt_m = np.zeros((W, n_slots * Pk), bool)
            lane_m = np.zeros(W, bool)
            for li in range(W):
                pi = sched.lane[li]
                occ = occupants[li]
                n_out = host["job_n_out"][li]
                for sl in range(n_slots):
                    if occ[sl] is None:
                        continue
                    if n_out[sl] > 0 and out_done[li, sl] >= n_out[sl]:
                        a = trace[occ[sl]]
                        job_rows[pi].append(
                            (occ[sl], a.cls, a.t,
                             float(admit_t[li, sl]),
                             float(done_t[li, sl])))
                        occ[sl] = None
                        stats.retired += 1
                for sl in range(n_slots):
                    if occ[sl] is None and ptr[li] < n_trace:
                        load_slot(host, spec, li, sl, trace[ptr[li]].job)
                        occ[sl] = ptr[li]
                        ptr[li] += 1
                        job_m[li, sl] = True
                        task_m[li, sl * T:(sl + 1) * T] = True
                        pkt_m[li, sl * Pk:(sl + 1) * Pk] = True
                        lane_m[li] = True
                        stats.loads += 1
                        stats.refills += 1
                loaded = any(o is not None for o in occ)
                if stalled[li] and loaded:
                    raise RuntimeError(
                        f"stream lane {exp.policy_names[pi]!r} stalled at "
                        f"t={float(t_arr[li])} with jobs in flight")
                if done[li] and loaded and not lane_m[li]:
                    raise RuntimeError(
                        f"stream lane {exp.policy_names[pi]!r} exhausted "
                        f"its step budget ({meta.max_steps}) between "
                        "refills — raise chunk capacity or shrink jobs")
                # torchcheck: disable=tracer-cast: numpy on the host
                samples[pi].append((float(t_arr[li]), float(he[li].sum()),
                                    float(se[li].sum()),
                                    float(hb[li].sum())))
            if lane_m.any():
                consts_dev = _upload(consts0, host, dev)
                masks = (torch.from_numpy(m).to(dev)
                         for m in (job_m, task_m, pkt_m, lane_m))
                carry = refill(consts_dev, carry, *masks)
        fs = carry[0]
        # torchcheck: disable=item-call: the ledger's reads at a chunk
        # boundary
        (c_sl, c_sw, c_ww, c_dg, c_fo, c_fp) = (a.cpu().numpy() for a in (
            fs.spec_launches, fs.spec_wins, fs.spec_wasted,
            fs.degraded_time, fs.ctrl_failovers, fs.ctrl_failover_park))
        for li in range(W):
            chaos[sched.lane[li]] = {
                "spec_launches": int(c_sl[li]),
                "spec_wins": int(c_sw[li]),
                "wasted_spec_work_s": float(c_ww[li]),
                "degraded_time_s": float(c_dg[li]),
                "failover_count": int(c_fo[li]),
                "failover_park_s": float(c_fp[li]),
            }
        if return_states:
            for li in range(W):
                finals[sched.lane[li]] = type(fs)(*(leaf[li] for leaf in fs))
                # the consts this lane's final state actually ran against
                # (its LAST ring generation): what invariant checkers need
                finals_c[sched.lane[li]] = consts0._replace(
                    **{f: torch.from_numpy(host[f][li].copy()).to(dev)
                       for f in STREAM_FIELDS})

    jobs = {}
    for pi in range(P):
        rows = sorted(job_rows[pi])
        cols = (np.asarray(rows, float).reshape(len(rows), 5).T
                if rows else np.zeros((5, 0)))
        done_col = cols[4]
        jobs[pi] = {
            "seq": cols[0].astype(int), "cls": cols[1].astype(int),
            "t_arr": cols[2], "t_admit": cols[3], "t_done": done_col,
            "sojourn": done_col - cols[2],
        }
    return StreamResults(
        scenario_name=sname, policy_names=exp.policy_names,
        classes=classes, horizon=float(horizon), warmup=float(warmup),
        window_s=float(window), meta=meta, jobs=jobs,
        samples={pi: np.asarray(v, float) for pi, v in samples.items()},
        stats=stats, final_states=finals if return_states else None,
        final_consts=finals_c if return_states else None, chaos=chaos)
