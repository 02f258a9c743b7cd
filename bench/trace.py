"""What the benchmark records around the calls into each layer: host-clock
spans, the device's busy intervals from one profiler window, and the
host syncs of one experiment.  Spans are the benchmark's own (no span
inside the program yet); every span that ends after device work ends in
a synchronise, so its time includes that work."""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Host-clock spans ``(name, start, end, attrs)`` in memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans: List[Tuple[str, float, float, dict]] = []
        # the wall clock (ns since the epoch, the profiler's clock) less
        # the span clock
        self._ns0 = time.time_ns() - int(time.perf_counter() * 1e9)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """A span around the block, closed after a synchronise; the block
        may add to ``attrs``."""
        t0 = time.perf_counter()
        yield attrs
        sync(self.device)
        self.spans.append((name, t0, time.perf_counter(), attrs))

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1, _ in self.spans if n == name]

    def attrs(self, name: str) -> List[dict]:
        return [a for n, _, _, a in self.spans if n == name]

    def wall_spans(self) -> List[Tuple[int, int, str]]:
        """Every span as ``(start, end, name)`` in the profiler's ns."""
        return [(int(t0 * 1e9) + self._ns0, int(t1 * 1e9) + self._ns0, n)
                for n, t0, t1, _ in self.spans]


def count_syncs(fn) -> Tuple[object, int]:
    """``(fn(), host syncs the CUDA runtime reported meanwhile)``:
    ``torch.cuda.set_sync_debug_mode`` warns once for each copy to the
    host and each blocking call."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


Events = Tuple[Sequence[int], Sequence[int], Sequence[str]]


def _sorted(intervals) -> np.ndarray:
    """``[n, 2]`` int64 ``(start, end)`` rows, empty ones dropped, sorted
    by start."""
    iv = np.asarray(intervals, np.int64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    return iv[np.argsort(iv[:, 0], kind="stable")]


def union_length(intervals) -> int:
    """Total length covered by ``[start, end)`` intervals (overlaps
    counted once)."""
    iv = _sorted(intervals)
    if not len(iv):
        return 0
    before = np.concatenate(([np.iinfo(np.int64).min],
                             np.maximum.accumulate(iv[:-1, 1])))
    return int(np.maximum(0, iv[:, 1] - np.maximum(iv[:, 0], before)).sum())


def gaps(intervals, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """The starts and ends of the stretches of ``[lo, hi)`` that no
    interval covers."""
    iv = _sorted(intervals)
    cover = np.maximum.accumulate(np.concatenate(([lo], iv[:, 1])))
    a = np.clip(cover, lo, hi)
    b = np.clip(np.concatenate((iv[:, 0], [hi])), lo, hi)
    keep = b > a
    return a[keep], b[keep]


def _in_flight(events: Events, t: np.ndarray) -> Tuple[np.ndarray, list]:
    """For each instant of ``t``, the index into ``names`` of the event
    that started last at or before it and still runs (``-1``: none), and
    the names."""
    starts, ends, names = (np.asarray(events[0], np.int64),
                           np.asarray(events[1], np.int64), list(events[2]))
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    names = [names[i] for i in order]
    i = np.searchsorted(starts, t, side="right") - 1
    ok = i >= 0
    ok[ok] = ends[i[ok]] > t[ok]
    return np.where(ok, i, -1), names


def breakdown(device: Events, host: Events, spans: Events, lo: int, hi: int,
              top: int = 10) -> dict:
    """The ``top`` device operations by summed time, and the idle time of
    ``[lo, hi)`` summed by what the host was doing at each gap's middle:
    the benchmark's span there (build, run, report) and the
    CUDA runtime call in flight, or ``host`` (Python and dispatch) when
    none is (seconds, from nanosecond events as ``(starts, ends,
    names)``)."""
    by_op: Dict[str, int] = {}
    for a, b, name in zip(*device):
        by_op[name] = by_op.get(name, 0) + (b - a)
    ga, gb = gaps(np.stack([np.asarray(device[0], np.int64),
                                   np.asarray(device[1], np.int64)], 1),
                         lo, hi)
    mid = (ga + gb) // 2
    si, snames = _in_flight(spans, mid)
    hi_, hnames = _in_flight(host, mid)
    idle: Dict[str, int] = {}
    for s, h, length in zip(si.tolist(), hi_.tolist(), (gb - ga).tolist()):
        key = (f"{snames[s] if s >= 0 else 'outside'}/"
               f"{hnames[h] if h >= 0 else 'host'}")
        idle[key] = idle.get(key, 0) + length

    def ranked(d):
        return [[k[:120], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}


def profile_window(fn, rec: Recorder) -> Tuple[object, dict]:
    """``(fn(), trace)``: ``fn`` (which records its spans in ``rec``) run
    under ``torch.profiler`` with the device's activity only, after a
    synchronise and up to one: tracing the host's ops as well slows this
    host-bound loop several times over and would inflate the idle share.
    ``trace`` holds ``busy_s`` (the union of the device's operation
    intervals), ``window_s`` (the profiled wall time), the count of device
    operations, the breakdown, and ``cost_s``: the seconds it took to stop
    the profiler, to list its events, to read them and to reduce them.
    The kineto events are read as they are, without the profiler's slow
    per-event parse."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device = rec.device
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        out = fn()
        sync(device)
        t1 = time.time_ns()
        cost = [time.perf_counter()]
    cost.append(time.perf_counter())
    events = prof.profiler.kineto_results.events()
    cost.append(time.perf_counter())
    dev: Events = ([], [], [])
    host: Events = ([], [], [])
    cuda = DeviceType.CUDA
    for e in events:
        into = dev if e.device_type() == cuda else host
        start = e.start_ns()
        into[0].append(start)
        into[1].append(start + e.duration_ns())
        into[2].append(e.name())
    del events
    cost.append(time.perf_counter())
    wall = rec.wall_spans()
    trace = {"busy_s": union_length(np.stack(
                 [np.asarray(dev[0], np.int64),
                  np.asarray(dev[1], np.int64)], 1)) / 1e9,
             "window_s": (t1 - t0) / 1e9, "device_ops": len(dev[0]),
             "breakdown": breakdown(dev, host, tuple(zip(*wall)) or
                                    ([], [], []), t0, t1)}
    cost.append(time.perf_counter())
    trace["cost_s"] = [round(b - a, 3) for a, b in zip(cost, cost[1:])]
    return out, trace


def apsp_device_s(fn, device: torch.device) -> Tuple[object, Optional[float]]:
    """``(fn(), device seconds of its APSP kernel launches)`` from a
    profiler window; ``None`` when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return fn(), None
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync(device)
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")
             and "apsp" in e.name())
    return out, (ns / 1e9 if ns > 0 else None)
