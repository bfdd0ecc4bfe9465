"""Set-up: process start to the first timed solve (imports, data, problem
built, compiled and captured, warm-up solves)."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", None


def read(run):
    return run.setup_s
