"""SE(3) pose-graph optimization (port of ``nllstpu/models/posegraph.py``):
poses on SE(3) joined by relative-transform measurements (odometry and
loop closures), one per-cost residual per edge, Jacobians by autodiff
through the retraction.  The graph is not bipartite: the dense backend
takes it.  :func:`pose_graph_data` draws the JAX package's data, seed for
seed, so both packages solve the same numbers."""

from __future__ import annotations

import numpy as np
import torch

from ..core.manifolds import SE3, so3_log
from ..core.problem import Problem

POSE = SE3()


def relative_pose_residual(measurement, pose_i, pose_j):
    """6-vector residual of a relative SE(3) measurement Z = (R_z | t_z):
    [log(R_zᵀ R_iᵀ R_j), R_iᵀ(t_j − t_i) − t_z], in full precision
    (PyTorch's float32 matmuls do not use TF32 unless asked)."""
    r_z, t_z = measurement[:, :3], measurement[:, 3]
    r_i, t_i = pose_i[:, :3], pose_i[:, 3]
    r_j, t_j = pose_j[:, :3], pose_j[:, 3]
    e_rot = so3_log(r_z.T @ (r_i.T @ r_j))
    e_t = r_i.T @ (t_j - t_i) - t_z
    return torch.cat([e_rot, e_t])


def _np_se3(r, t):
    return np.concatenate([r, t[:, None]], axis=1)


def _np_so3_exp(w):
    """Host-side Rodrigues (the JAX package's ``_np_so3_exp``)."""
    theta = np.linalg.norm(w)
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    a = np.sin(theta) / theta
    b = (1.0 - np.cos(theta)) / (theta * theta)
    return np.eye(3) + a * k + b * (k @ k)


def pose_graph_data(n_poses=20, n_loops=5, noise=0.0, perturb=0.05, seed=1):
    """``(init [n, 3, 4], edges [m, 2], measurements [m, 3, 4], truth)``:
    ground-truth poses on a circle, odometry edges between consecutive
    poses and back to the first, ``n_loops`` random loop closures,
    measurements from the truth (+ noise), and the start perturbed in the
    tangent space; the JAX package's ``make_pose_graph`` draws."""
    rng = np.random.default_rng(seed)

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    truth = []
    for i in range(n_poses):
        ang = 2 * np.pi * i / n_poses
        t = np.array([np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)])
        truth.append(_np_se3(rotz(ang), t))
    truth = np.stack(truth)
    edges = [(i, i + 1) for i in range(n_poses - 1)] + [(n_poses - 1, 0)]
    for _ in range(n_loops):
        i, j = rng.choice(n_poses, size=2, replace=False)
        edges.append((int(i), int(j)))
    meas = []
    for i, j in edges:
        r_i, t_i = truth[i][:, :3], truth[i][:, 3]
        r_j, t_j = truth[j][:, :3], truth[j][:, 3]
        r_z = r_i.T @ r_j
        t_z = r_i.T @ (t_j - t_i)
        if noise:
            r_z = r_z @ _np_so3_exp(rng.standard_normal(3) * noise)
            t_z = t_z + rng.standard_normal(3) * noise
        meas.append(_np_se3(r_z, t_z))
    init = truth.copy()
    for i in range(1, n_poses):
        w = rng.standard_normal(3) * perturb
        v = rng.standard_normal(3) * perturb
        r = init[i][:, :3] @ _np_so3_exp(w)
        t = init[i][:, 3] + init[i][:, :3] @ v
        init[i] = _np_se3(r, t)
    return init, np.array(edges, dtype=np.int32), np.stack(meas), truth


def make_pose_graph(n_poses=20, n_loops=5, noise=0.0, perturb=0.05, seed=1, dtype=None,
                    device=None):
    """The pose graph of :func:`pose_graph_data`; returns ``(problem,
    pose_handles, ground_truth [n, 3, 4])``."""
    init, edges, meas, truth = pose_graph_data(n_poses, n_loops, noise, perturb, seed)
    p = Problem(dtype=dtype, device=device)
    poses = p.add_variables(POSE, init)
    p.add_cost_batch(
        relative_pose_residual,
        slots=[(POSE, edges[:, 0]), (POSE, edges[:, 1])],
        params=meas,
        batched=False,
    )
    return p, poses, truth
