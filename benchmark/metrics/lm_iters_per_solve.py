"""LM iterations per solve (``Result.num_iterations``) over the window."""

LAYER = "iterators"
UNIT, SOURCE, MOVES = "iters", "program_counter", "solve_s"


def read(run):
    return sum(s["iterations"] for s in run.solves) / len(run.solves) if run.solves else None
