"""Device idle milliseconds per LM iteration inside the graph pieces' spans
(``nt.piece.<piece>``: a piece's launch through the host read of its
outputs), over the traced solves' iterations: the card waiting on graph
launches and on the reads of λ trials and PCG flags."""

from benchmark.metrics._kernels import profiled
from benchmark.metrics._spans import idle_split

LAYER = "driver, graph"
UNIT, SOURCE, MOVES = "ms", "program_span", "solve_s"


def read(run):
    split = idle_split(run.trace)
    iters = sum(s["iterations"] for s in profiled(run))
    return 1e3 * split["piece"] / iters if split and split["pieces"] and iters else None
