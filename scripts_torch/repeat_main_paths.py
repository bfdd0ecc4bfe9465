"""Repeat the LM main paths of ``chip_smoke.py`` on one CUDA card and count
how each run ended.

    python3 scripts_torch/repeat_main_paths.py [--reps 300] [--bal-reps 20]

Float32 LM at its rounding floor takes a different damping path from run
to run (kernel B1's float atomics), so a fault that needs one unlucky
damped system shows in a fraction of runs.  The pinhole bench path runs
``--reps`` times twice: with the port's reduced solve, and with its
earlier failure test (``cholesky_ex``'s ``info`` alone, no check of the
solution), in turns.  Ladybug-49 and bench-realistic run ``--bal-reps``
times with the port's solve.  For each: the termination reasons with
their counts, the runs that ended on a NaN cost or step, the range of the
best cost, and the reduced solves whose factorization reported success
yet gave a non-finite solution.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import nllstpu_torch as nt  # noqa: E402
from nllstpu_torch.core import linearsolver, structs  # noqa: E402
from nllstpu_torch.ops import schur  # noqa: E402

COUNTS = collections.Counter()


def counted_solve(a, b):
    """The port's reduced solve, counting factorizations that report
    success but give a non-finite solution (one extra factorization)."""
    aa = a
    if a.dtype == torch.float32:
        diag = torch.diagonal(a).abs()
        d = torch.where(diag > 0, torch.rsqrt(diag), torch.ones_like(diag))
        aa = a * d[:, None] * d[None, :]
        b_s = b * d
    else:
        b_s = b
    chol, info = torch.linalg.cholesky_ex(aa)
    x = torch.cholesky_solve(b_s[:, None], chol)[:, 0]
    COUNTS["solves"] += 1
    COUNTS["info failed"] += int(info != 0)
    COUNTS["info ok, solution non-finite"] += int(
        bool((info == 0) & ~torch.isfinite(x).all()))
    return linearsolver.cholesky_solve(a, b)


def info_only_solve(a, b):
    """The reduced solve with ``info`` as its only failure test."""
    d = None
    if a.dtype == torch.float32:
        diag = torch.diagonal(a).abs()
        d = torch.where(diag > 0, torch.rsqrt(diag), torch.ones_like(diag))
        a = a * d[:, None] * d[None, :]
        b = b * d
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) == 0:
        x = torch.cholesky_solve(b[:, None], chol)[:, 0]
    else:
        x, _ = torch.linalg.solve_ex(a, b)
    return x if d is None else d * x


def run(label, make, reps, solve):
    schur.cholesky_solve = solve
    COUNTS.clear()
    ends, best, nan_runs = collections.Counter(), [], 0
    for _ in range(reps):
        res = nt.optimize(make(), cs.bench_options())
        ends[" ".join(res.termination_reasons())] += 1
        best.append(res.best_cost)
        nan_runs += bool(res.termination & (structs.TERM_COST_NAN | structs.TERM_STEP_NAN))
    print(f"{label}: {reps} runs, {nan_runs} ended on a NaN cost or step, best cost "
          f"{min(best)!r}..{max(best)!r}, reduced solves {dict(COUNTS)}", flush=True)
    for reason, n in ends.most_common():
        print(f"    {n:4d} x {reason}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--bal-reps", type=int, default=20)
    args = ap.parse_args()
    device, smi = cs.phase_device()
    cs.phase_build()
    pin = lambda: cs.bench_problem(device)  # noqa: E731
    half = args.reps // 2
    for turn in range(2):
        run(f"pinhole bench, port's solve, turn {turn}", pin, half, counted_solve)
        run(f"pinhole bench, info-only solve, turn {turn}", pin, half, info_only_solve)
    for name in cs.BAL:
        run(name, lambda name=name: cs.bal_problem(name, device), args.bal_reps,
            counted_solve)
    print(smi)


if __name__ == "__main__":
    main()
