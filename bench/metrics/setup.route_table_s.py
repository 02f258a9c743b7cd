"""Host-clock seconds of set-up's one build of the configuration's route
table (fabric, APSP, DFS), synchronised."""


def read(run):
    spans = run.rec.durations("setup.route_table")
    return spans[0] if spans else None
