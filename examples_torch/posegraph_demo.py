"""SE(3) pose-graph optimization with the matrix-free CG backend (the port
of examples/posegraph_demo.py).

Run:  python examples_torch/posegraph_demo.py [--cpu]
"""

import numpy as np
import torch

from _device import device

import nllstpu_torch as nt
from nllstpu_torch.models.posegraph import make_pose_graph


def main():
    problem, poses, truth = make_pose_graph(n_poses=64, n_loops=16, noise=0.005, perturb=0.1,
                                            dtype=torch.float64, device=device())
    print(problem)
    print(f"initial cost: {nt.cost(problem):.6e}")
    result = nt.optimize(problem, nt.Options(iterator=nt.LEVENBERG_MARQUARDT, solver="cg"),
                         unfixed=poses[1:])  # pose 0 anchors the gauge
    print(result)
    final = np.stack([problem.get_value(h) for h in poses])
    err = np.linalg.norm(final[:, :, 3] - np.asarray(truth)[:, :, 3], axis=1)
    print(f"translation error: mean {err.mean():.2e}, max {err.max():.2e}")


if __name__ == "__main__":
    main()
