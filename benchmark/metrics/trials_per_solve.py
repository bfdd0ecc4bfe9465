"""Damped trials per solve (``Result.linear_solves``: each a reduced solve)
over the window: with ``lm_iters_per_solve``, the counts that move the
solve time without a change of speed."""

LAYER = "iterators"
UNIT, SOURCE, MOVES = "trials", "program_counter", "solve_s"


def read(run):
    return sum(s["linear_solves"] for s in run.solves) / len(run.solves) if run.solves else None
