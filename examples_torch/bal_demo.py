"""Bundle adjustment of a BAL problem with the Schur backend, then a
landmark polish by per-variable alternation (the port of
examples/bal_demo.py).

Run:  python examples_torch/bal_demo.py [--cpu] [path/to/problem.txt]

Without a path a synthetic BAL-format problem is built (measurements from
the ground truth plus noise).  A BAL file (grail.cs.washington.edu/
projects/bal) is read by the native C++ parser.
"""

import sys

import torch

from _device import device

import nllstpu_torch as nt
from nllstpu_torch.models import bal
from nllstpu_torch.utils import native


def main():
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        data = bal.load_bal(paths[0])
        print(f"loaded {data['cameras'].shape[0]} cameras, {data['points'].shape[0]} points, "
              f"{data['cam_idx'].shape[0]} observations ({native.LAST_PARSER} parser)")
    else:
        data = bal.make_synthetic_bal(16, 512, obs_per_point=6, noise=0.5)
        print("synthetic BAL problem (16 cameras, 512 points)")
    problem, cams, pts = bal.make_bal_problem(data, dtype=torch.float64, device=device(),
                                              robust_width=2.0)
    print(problem)
    print(f"initial cost: {nt.cost(problem):.6e}")
    result = nt.optimize(problem, nt.Options(iterator=nt.LEVENBERG_MARQUARDT, solver="schur",
                                             schur_family=bal.PT, max_iters=50))
    print(result)
    iters = nt.optimize_singles(problem, nt.Options(), targets=bal.PT)
    print(f"landmark polish: {iters[nt.family_name(bal.PT)]} iterations over "
          f"{len(pts)} points, cost {nt.cost(problem):.6e}")


if __name__ == "__main__":
    main()
