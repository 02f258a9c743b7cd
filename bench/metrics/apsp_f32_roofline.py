"""The APSP kernel's share of its roofline: the least time the card could
take for the squarings these hop distances need (``peaks.apsp_bound_s``)
over the kernel's device time in the profiler, when the traced run
launches the route table's APSP again after its window."""
from bench.peaks import apsp_bound_s


def read(run):
    c = run.counters
    if not c.get("apsp.device_s"):
        return None
    return 100.0 * apsp_bound_s(c["apsp.n"], c["apsp.max_hops"]) \
        / c["apsp.device_s"]
