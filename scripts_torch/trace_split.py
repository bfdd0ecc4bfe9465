"""One traced run of a benchmark cell, with the card's idle time split by the
program's own spans and the program's counters beside it.

    python3 scripts_torch/trace_split.py --workload <cell> --seed <n> [--seconds 10]

Runs ``benchmark/run.py``'s traced run (``--trace 1``) in this process and,
beside its result line, prints on standard error a line ``trace_split
{json}``: the readers' idle split (``benchmark/metrics/_spans.py``: inside
each graph piece's span, inside ``nt.optimize`` outside the pieces, inside
the harness's ``optimize`` spans outside ``nt.optimize``, and outside); the
device idle share; the traced solves' wall milliseconds per LM iteration;
and the process totals (``profiling.totals()``: replays per piece, PCG
iterations, set-up seconds by phase).  The split comes from the run
itself, so the harness's ``read_metrics`` is wrapped to see it.  Run from
the root of a checkout on a machine with a card; what the spans cost
while the profiler records: ``scripts_torch/span_cost.py``.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402


def split(run) -> dict:
    """The idle split of ``run``'s trace (:func:`_spans.idle_split`), the
    traced solves' wall milliseconds per LM iteration, and the totals."""
    t = run.trace
    traced, rest = run.solves[:run.profiled], run.solves[run.profiled:]
    iters = sum(s["iterations"] for s in traced)
    idle = t.window_s - t.busy_s
    return {
        "window_s": t.window_s, "idle_s": idle, "device_idle_pct": 100.0 * idle / t.window_s,
        "traced_solves": len(traced), "traced_iterations": iters,
        "traced_ms_per_iter": 1e3 * sum(s["wall_s"] for s in traced) / iters if iters else None,
        "untraced_ms_per_iter": (1e3 * sum(s["wall_s"] for s in rest)
                                 / max(1, sum(s["iterations"] for s in rest))),
        "idle_split_s": _spans.idle_split(t),
        "totals": _spans.totals(),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args()
    read_metrics = harness.read_metrics

    def report(run):
        out = dict(workload=args.workload, seed=args.seed, **split(run))
        print("trace_split " + json.dumps(out), file=sys.stderr, flush=True)
        return read_metrics(run)

    harness.read_metrics = report
    return harness.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"], START)


if __name__ == "__main__":
    sys.exit(main())
