"""Host seconds of ``compile_problem``'s layout and route (the set-up span
``nt.compile.layout``: relabel, route, sorts), summed over the process's
``optimize`` calls: one compile per run, in set-up's first solve."""

from benchmark.metrics._spans import totals

LAYER = "compile"
UNIT, SOURCE, MOVES = "s", "program_span", "setup_s"


def read(run):
    t = totals()
    return t["setup.compile.layout"] if t and "setup.compile.layout" in t else None
