"""Damped trials whose f32 Cholesky failed and were taken again through LU
(the graph piece ``trial_lu``'s replays) per ``optimize`` call, over every
call of the process, set-up's warm-up solve included (the starts are the
configuration's, so the ratio repeats from run to run)."""

from benchmark.metrics._spans import totals

LAYER = "solve, direct"
UNIT, SOURCE, MOVES = "trials", "program_counter", "solve_s"


def read(run):
    t = totals()
    if not t or not t["optimize_calls"] or "replays.trial" not in t:
        return None
    return t["replays.trial_lu"] / t["optimize_calls"]
