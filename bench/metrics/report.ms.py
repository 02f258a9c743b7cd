"""Milliseconds of one experiment's report: the Eqs. 6-9 job report and
the energy report read to host numpy, the mean over the window."""


def read(run):
    spans = run.rec.durations("report")
    return 1e3 * sum(spans) / len(spans) if spans else None
