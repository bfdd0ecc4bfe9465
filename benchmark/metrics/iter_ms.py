"""Wall milliseconds per LM iteration on the graph driver: the host clock
over the window's solves that ran outside the profiler, over their
iterations."""

LAYER = "driver, graph"
UNIT, SOURCE, MOVES = "ms", "host_clock", "solve_s"


def read(run):
    solves = run.solves[run.profiled:] or run.solves
    iters = sum(s["iterations"] for s in solves)
    return 1e3 * sum(s["wall_s"] for s in solves) / iters if iters else None
