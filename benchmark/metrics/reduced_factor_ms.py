"""Device milliseconds per damped solve in the library's factorization and
triangular-solve kernels (cuSOLVER, cuBLAS) of the reduced camera system,
over the traced solves' ``Result.linear_solves``."""

from benchmark.metrics._kernels import port_kernel, profiled

LAYER = "solve, direct"
UNIT, SOURCE, MOVES = "ms", "device_trace", "solve_s"
NAMES = ("getrf", "getrs", "potrf", "potrs", "trsv", "trsm", "laswp")


def factor_kernel(name: str) -> bool:
    return not port_kernel(name) and "at::" not in name and any(n in name for n in NAMES)


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernel_seconds(factor_kernel)
    solves = sum(s["linear_solves"] for s in profiled(run))
    return 1e3 * seconds / solves if n and solves else None
