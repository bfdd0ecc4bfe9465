"""PCG iterations per damped solve of the implicit route (``Result.
pcg_iterations``), over every ``optimize`` call of the process, set-up's
warm-up solve included (the starts are the configuration's, so the ratio
repeats from run to run)."""

from benchmark.metrics._spans import totals

LAYER = "solve, implicit"
UNIT, SOURCE, MOVES = "iters", "program_counter", "solve_s"


def read(run):
    t = totals()
    return t["pcg_iterations"] / t["pcg_solves"] if t and t["pcg_solves"] else None
