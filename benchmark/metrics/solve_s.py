"""The window's wall time over the solves completed in it: the mean wall
time to a solved problem, over all the work and all the time of the window."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", None


def read(run):
    return run.window_s / len(run.solves) if run.solves else None
