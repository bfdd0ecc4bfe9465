"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] --solves <k>

For each seed, at the cell's own size, the first ``k`` solves of the
window's order, judged by the kind's own judgment (``Workload.judge``, as a
run judges them): the program's (``Workload``) and the control's
(``Control``: the reference in TF32 put in the program's place).  Prints
one JSON line per seed.  The benchmark's own runs do not run it.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(cls, cell, seed: int, solves: int, device) -> dict:
    """``cls``'s solves judged: the worst of each compared number, the
    solves that failed a limit, and each solve's LM iterations."""
    w = cls(cell.config, cell.traffic, seed, device)
    recs = [w.solve(("window", i)) for i in range(solves)]
    w.release()
    checks, failed = w.judge(recs)
    return dict(checks={k: c["value"] for k, c in checks.items()}, failed=failed,
                iterations=[r["iterations"] for r in recs],
                trials=[r["linear_solves"] for r in recs])


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--solves", type=int, required=True)
    args = parser.parse_args(argv)
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(manifest, args.workload, False)
    kind = harness.load_module(harness.HERE / "kinds" / f"{cell.config['kind']}.py")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        out = dict(seed=seed, limits=cell.config["limits"])
        for name, cls in (("program", kind.Workload), ("control", kind.Control)):
            out[name] = readings(cls, cell, seed, args.solves, device)
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
