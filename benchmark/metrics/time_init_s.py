"""``Result.time_init`` of set-up's first ``optimize``: compile_problem (host
layout, tables, upload) and the graph driver's warm-up and captures."""

LAYER = "compile"
UNIT, SOURCE, MOVES = "s", "program_span", "setup_s"


def read(run):
    return run.time_init_s
