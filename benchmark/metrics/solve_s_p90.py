"""The 90th percentile of each solve's wall time (host clock around the
``optimize`` call, which ends in its result), over every solve of the window."""

import statistics

LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", None


def read(run):
    walls = [s["wall_s"] for s in run.solves]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
