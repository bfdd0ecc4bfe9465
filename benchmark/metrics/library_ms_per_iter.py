"""Device milliseconds per LM iteration in kernels that are not the port's
own (PyTorch's elementwise, reduction and gather kernels, cuBLAS, cuSOLVER),
by name, over the traced solves' iterations."""

from benchmark.metrics._kernels import port_kernel, profiled

LAYER = "solve, implicit"
UNIT, SOURCE, MOVES = "ms", "device_trace", "solve_s"


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernel_seconds(lambda k: not port_kernel(k))
    iters = sum(s["iterations"] for s in profiled(run))
    return 1e3 * seconds / iters if n and iters else None
