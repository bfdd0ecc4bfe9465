"""Host seconds of the graph driver's warm-up, captures and first replays
(the set-up spans ``nt.graph.warmup``, ``nt.graph.capture``,
``nt.graph.upload``), summed over the process's ``optimize`` calls: one
runner per run, built in set-up's first solve."""

from benchmark.metrics._spans import totals

LAYER = "driver, graph"
UNIT, SOURCE, MOVES = "s", "program_span", "setup_s"


def read(run):
    t = totals()
    phases = [v for k, v in (t or {}).items() if k.startswith("setup.graph.")]
    return sum(phases) if phases else None
