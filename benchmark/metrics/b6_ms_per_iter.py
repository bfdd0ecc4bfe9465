"""Device milliseconds per LM iteration in B6's kernels (``segment_chunks``,
``segment_combine``), by name, over the traced solves' iterations."""

from benchmark.metrics._kernels import port_kernel, profiled

LAYER = "sums"
UNIT, SOURCE, MOVES = "ms", "device_trace", "solve_s"


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernel_seconds(
        lambda k: port_kernel(k, "segment_chunks_kernel", "segment_combine_kernel"))
    iters = sum(s["iterations"] for s in profiled(run))
    return 1e3 * seconds / iters if n and iters else None
