"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Everything the cell needs is found by the names in ``BENCHMARK.json``
(see ``benchmark/harness.py``).
"""

import time

START = time.perf_counter()  # set-up is counted from here

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START))
