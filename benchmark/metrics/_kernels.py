"""Kernel names, as the profiler reports them, shared by the readers."""


def port_kernel(name: str, *bases) -> bool:
    """One of the port's own kernels (``ops/csrc``'s anonymous namespaces),
    of base name ``bases`` if given."""
    if "(anonymous namespace)::" not in name or "at::" in name:
        return False
    base = name.split("(anonymous namespace)::", 1)[1].split("<", 1)[0].split("(", 1)[0]
    return not bases or base in bases


def profiled(run):
    """The solves the trace holds."""
    return run.solves[:run.profiled]
