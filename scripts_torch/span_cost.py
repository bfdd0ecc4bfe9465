"""What the program's spans cost while the profiler records: one benchmark
cell's solves in profiled blocks, the spans on and off in turn (on, off,
off, on, ...), in one process, so that set-up, data and the card are shared.

    python3 scripts_torch/span_cost.py --workload <cell> --seed <n> [--blocks 20] [--cycles 3]

Builds the cell as ``benchmark/run.py`` does and runs its warm-up solve;
then each block profiles ``--cycles`` whole cycles of the cell's starts
(``torch.profiler``, CPU and CUDA, as the benchmark's traced run) with the
spans on (``profiling.span`` as it is) or off (the shared null context;
the set-up spans are not in a block).  Prints one JSON line a block (wall
ms per LM iteration of the block's solves, device idle share of the
traced window), then the medians by side and the on − off differences of
consecutive pairs.  Run from the root of a checkout on a machine with a
card; ``--blocks`` a multiple of 4.
"""

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--blocks", type=int, default=20)
    parser.add_argument("--cycles", type=int, default=3)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import harness, trace
    from nllstpu_torch.utils import profiling

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(manifest, args.workload, True)
    kind = harness.load_module(ROOT / "benchmark" / "kinds" / f"{cell.config['kind']}.py")
    workload = kind.Workload(cell.config, cell.traffic, args.seed, torch.device("cuda", 0))
    for i in range(cell.traffic["warmup_solves"]):
        workload.solve(("warmup", i))
    workload.synchronize()
    span = profiling.span
    rows = []
    for block, side in enumerate(["on", "off", "off", "on"] * (args.blocks // 4)):
        profiling.span = span if side == "on" else (lambda name: profiling._NULL)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        solves = []
        for i in range(args.cycles * workload.cycle):
            with record_function("solve"):
                solves.append(workload.solve(("window", i)))
        workload.synchronize()
        prof.stop()
        profiling.span = span
        t = trace.read(prof)
        iters = sum(s["iterations"] for s in solves)
        rows.append(dict(block=block, spans=side, iterations=iters,
                         ms_per_iter=1e3 * sum(s["wall_s"] for s in solves) / iters,
                         idle_pct=100.0 * (t.window_s - t.busy_s) / t.window_s))
        print(json.dumps(rows[-1]), flush=True)
    for key in ("ms_per_iter", "idle_pct"):
        med = {side: statistics.median(r[key] for r in rows if r["spans"] == side)
               for side in ("on", "off")}
        on_off = [(a[key] - b[key]) if a["spans"] == "on" else (b[key] - a[key])
                  for a, b in zip(rows[::2], rows[1::2])]
        print(f"{args.workload} {key}: median on {med['on']!r}, off {med['off']!r}; "
              f"on - off by pair {on_off}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
