"""B3's share of its structural roofline: the least time of one damped
reduction (``roofline.reduction_work`` of the cell's observation pattern,
float32) per reduction (one incidence pass each), over the device time of
its incidence, links and pair-sum kernels by name."""

from benchmark import roofline
from benchmark.metrics._kernels import port_kernel

LAYER = "solve, direct"
UNIT, SOURCE, MOVES = "%", "device_trace", "solve_s"
INCIDENCE = ("incidence_kernel", "incidence_tiled_kernel")
KERNELS = INCIDENCE + ("reduce_links_kernel", "reduce_links_tiled_kernel", "sum_links_kernel")


def read(run):
    if run.trace is None:
        return None
    reductions, _ = run.trace.kernel_seconds(lambda k: port_kernel(k, *INCIDENCE))
    _, seconds = run.trace.kernel_seconds(lambda k: port_kernel(k, *KERNELS))
    if not reductions:
        return None
    return 100.0 * reductions * roofline.bound_s(*roofline.reduction_work(run.shapes)) / seconds
