"""B2's share of its roofline: the least time of one assembly's work
(``roofline.assembly_work`` of the cell's shapes, float32) per launch of the
obs-major assembly kernel, over its device time by name."""

from benchmark import roofline
from benchmark.metrics._kernels import port_kernel

LAYER = "assemble, direct"
UNIT, SOURCE, MOVES = "%", "device_trace", "solve_s"


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernel_seconds(
        lambda k: port_kernel(k, "assemble_kernel", "assemble_any_kernel"))
    if not n:
        return None
    return 100.0 * n * roofline.bound_s(*roofline.assembly_work(run.shapes)) / seconds
