"""Host syncs the CUDA runtime reports over one whole experiment, over
its loop's trip count."""


def read(run):
    c = run.counters
    if not c.get("syncs.trip"):
        return None
    return c["syncs"] / c["syncs.trip"]
