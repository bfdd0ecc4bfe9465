"""The card's idle share over the traced solves: 1 − (union of the
intervals of kernels, copies and fills) ÷ the traced window."""

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "solve_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
