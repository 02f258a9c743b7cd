"""Milliseconds an event-loop step: the window's synchronised
``Experiment.run`` time over its trip counts (the largest step count of
the lanes of each run)."""


def read(run):
    runs = run.rec.attrs("run")
    trips = sum(a["trip"] for a in runs)
    if not trips:
        return None
    return 1e3 * sum(run.rec.durations("run")) / trips
