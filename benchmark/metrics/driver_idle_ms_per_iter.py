"""Device idle milliseconds per LM iteration inside ``nt.optimize`` but
outside every graph piece's span (the loop's Python, the runner cache, the
start's copy, ``set_values``, the ``Result``), over the traced solves'
iterations."""

from benchmark.metrics._kernels import profiled
from benchmark.metrics._spans import idle_split

LAYER = "driver, graph"
UNIT, SOURCE, MOVES = "ms", "program_span", "solve_s"


def read(run):
    split = idle_split(run.trace)
    iters = sum(s["iterations"] for s in profiled(run))
    return 1e3 * split["driver"] / iters if split and split["pieces"] and iters else None
