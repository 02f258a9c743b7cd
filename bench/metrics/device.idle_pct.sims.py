"""Percent of an experiment in which no operation ran on the device: 1 -
the union of the device's operation intervals in one profiled experiment
(run after the window, the same work as each of the window's) over the
mean wall time of the window's unprofiled experiments.  The profiler
slows the host's dispatch, so its own wall time would read the idle
share high; its device time does not grow with it."""


def read(run):
    t = run.trace
    spans = run.rec.durations("experiment")
    if not t or not t["busy_s"] or not spans:
        return None
    return 100.0 * (1.0 - t["busy_s"] * len(spans) / sum(spans))
