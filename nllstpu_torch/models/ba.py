"""Synthetic bundle-adjustment problems (port of ``nllstpu/models/ba.py``):
the reference's affine BA (``make_affine_ba``, single costs), and SE(3)
poses with a pinhole projection (``make_pinhole_ba``) in each of the JAX
package's batch forms: per-cost (autodiff or the hand Jacobian),
row-major and components-major.

The host-side generation is line-for-line the JAX package's numpy code, so
the same seed draws the same numbers and gives bit-identical problem
arrays; only the residuals and their Jacobians are torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.manifolds import SE3, Euclidean
from ..core.problem import Problem
from ..core.robust import Huber


def _banded_visibility(ncameras, nlandmarks, prop_visible):
    """The reference's deterministic banded visibility mask
    (test/optimizeba.jl:22-23)."""
    cams = np.arange(1, ncameras + 1, dtype=np.float64)[:, None]
    centers = np.linspace(2, ncameras - 1, nlandmarks)[None, :]
    dist = np.abs(cams - centers)
    thresh = np.sort(dist.ravel())[int(np.ceil(dist.size * prop_visible)) - 1]
    return dist <= thresh


def affine_project(measurement, pose, point):
    """Residual of the affine two-row projection
    (test/optimizeba.jl:4): [pose[0:3]·X, pose[3:6]·X] − measurement."""
    return torch.stack([pose[:3] @ point, pose[3:] @ point]) - measurement


def make_affine_ba(ncameras=3, nlandmarks=5, prop_visible=1.0, seed=1, dtype=None,
                   device=None):
    """Ground-truth-consistent affine BA problem (the reference's BA
    workload, test/optimizeba.jl:3-47): 6-vector affine cameras, 3-vector
    landmarks, one single cost per visible pair, measurements from the
    truth.  Returns ``(problem, camera_handles, landmark_handles)``."""
    rng = np.random.default_rng(seed)
    p = Problem(dtype=dtype, device=device)
    cam_man, lmk_man = Euclidean(6), Euclidean(3)
    cam_offset = np.array([1.0, 0, 0, 0, 1.0, 0])
    cameras = [p.add_variable(cam_man, rng.standard_normal(6) + cam_offset)
               for _ in range(ncameras)]
    lmk_offset = np.array([-0.5, -0.5, 10.0])
    landmarks = [p.add_variable(lmk_man, rng.random(3) + lmk_offset)
                 for _ in range(nlandmarks)]
    cam_values = [p.get_value(c) for c in cameras]
    lmk_values = [p.get_value(lm) for lm in landmarks]
    vis = _banded_visibility(ncameras, nlandmarks, prop_visible)
    for ci in range(ncameras):
        pose = cam_values[ci]
        for li in range(nlandmarks):
            if vis[ci, li]:
                point = lmk_values[li]
                meas = np.array([pose[:3] @ point, pose[3:] @ point])
                p.add_cost(affine_project, (cameras[ci], landmarks[li]), params=meas)
    return p, cameras, landmarks


def perturb_ba(problem, handles, scale, seed=2):
    """Add Gaussian noise to Euclidean-storage variables, per family
    (reference perturb_ba_problem, test/optimizeba.jl:38-47)."""
    rng = np.random.default_rng(seed)
    by_fam = {}
    for h in handles:
        by_fam.setdefault(h.family, []).append(h.index)
    for name, idxs in by_fam.items():
        fam = problem._families[name]
        idxs = np.asarray(idxs)
        noise = rng.standard_normal((len(idxs),) + fam.manifold.shape) * scale
        fam.values[idxs] = fam.values[idxs] + noise


def pinhole_project(measurement, pose, point):
    """Pinhole reprojection residual of one cost for an SE(3) camera
    ``pose [3, 4]`` (world-to-camera, X_c = Rᵀ(X − t)), projected to the
    normalized image plane."""
    xc = pose[:, :3].T @ (point - pose[:, 3])
    return xc[:2] / xc[2] - measurement


def pinhole_project_jacobian(measurement, pose, point):
    """Residual and hand Jacobian ``[2, 9]`` of :func:`pinhole_project` in
    SE(3)/R³ tangent coordinates (camera [w, v], then point; the JAX
    package's ``pinhole_project_jacobian`` has the derivation)."""
    r = pose[:, :3]
    xc = r.T @ (point - pose[:, 3])
    x, y, z = xc[0], xc[1], xc[2]
    inv_z = 1.0 / z
    res = xc[:2] * inv_z - measurement
    zero = torch.zeros_like(z)
    dpi = torch.stack([torch.stack([inv_z, zero, -x * inv_z * inv_z]),
                       torch.stack([zero, inv_z, -y * inv_z * inv_z])])
    skew_xc = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                           torch.stack([-y, x, zero])])
    return res, torch.cat([dpi @ skew_xc, -dpi, dpi @ r.T], dim=1)


def _camera_frame_batched(pose, point):
    r = pose[:, :, :3]
    d = point - pose[:, :, 3]
    xc0 = r[:, 0, 0] * d[:, 0] + r[:, 1, 0] * d[:, 1] + r[:, 2, 0] * d[:, 2]
    xc1 = r[:, 0, 1] * d[:, 0] + r[:, 1, 1] * d[:, 1] + r[:, 2, 1] * d[:, 2]
    xc2 = r[:, 0, 2] * d[:, 0] + r[:, 1, 2] * d[:, 1] + r[:, 2, 2] * d[:, 2]
    return r, xc0, xc1, xc2


def pinhole_project_batched(measurement, pose, point):
    """Row-major pinhole residual of a whole batch: ``pose [B, 3, 4]``,
    ``point [B, 3]``, ``measurement [B, 2]`` → ``[B, 2]``."""
    _, xc0, xc1, xc2 = _camera_frame_batched(pose, point)
    inv_z = 1.0 / xc2
    return torch.stack([xc0 * inv_z - measurement[:, 0], xc1 * inv_z - measurement[:, 1]],
                       dim=-1)


def pinhole_project_jacobian_batched(measurement, pose, point):
    """Row-major residual and hand Jacobian ``(r [B, 2], J [B, 2, 9])``
    (:func:`pinhole_project_jacobian`, expanded over the batch)."""
    r, xc0, xc1, xc2 = _camera_frame_batched(pose, point)
    inv_z = 1.0 / xc2
    u = xc0 * inv_z
    v = xc1 * inv_z
    res = torch.stack([u - measurement[:, 0], v - measurement[:, 1]], dim=-1)
    zero = torch.zeros_like(u)
    row0 = torch.stack([
        u * v, -(1.0 + u * u), xc1 * inv_z,
        -inv_z, zero, u * inv_z,
        (r[:, 0, 0] - r[:, 0, 2] * u) * inv_z, (r[:, 1, 0] - r[:, 1, 2] * u) * inv_z,
        (r[:, 2, 0] - r[:, 2, 2] * u) * inv_z,
    ], dim=-1)
    row1 = torch.stack([
        1.0 + v * v, -u * v, -xc0 * inv_z,
        zero, -inv_z, v * inv_z,
        (r[:, 0, 1] - r[:, 0, 2] * v) * inv_z, (r[:, 1, 1] - r[:, 1, 2] * v) * inv_z,
        (r[:, 2, 1] - r[:, 2, 2] * v) * inv_z,
    ], dim=-1)
    return res, torch.stack([row0, row1], dim=1)


def _camera_frame(pose_cm, point_cm):
    r00, r01, r02, t0 = pose_cm[0], pose_cm[1], pose_cm[2], pose_cm[3]
    r10, r11, r12, t1 = pose_cm[4], pose_cm[5], pose_cm[6], pose_cm[7]
    r20, r21, r22, t2 = pose_cm[8], pose_cm[9], pose_cm[10], pose_cm[11]
    dx = point_cm[0] - t0
    dy = point_cm[1] - t1
    dz = point_cm[2] - t2
    xc0 = r00 * dx + r10 * dy + r20 * dz
    xc1 = r01 * dx + r11 * dy + r21 * dz
    xc2 = r02 * dx + r12 * dy + r22 * dz
    return xc0, xc1, xc2


def pinhole_project_cm(measurement, pose_cm, point_cm):
    """Components-major pinhole residual: ``pose_cm [12, B]`` (row-major
    [3, 4] flattened), ``point_cm [3, B]``, ``measurement [B, 2]``; returns
    ``[2, B]``.  World-to-camera convention X_c = Rᵀ(X − t)."""
    xc0, xc1, xc2 = _camera_frame(pose_cm, point_cm)
    inv = 1.0 / xc2
    m = measurement.T
    return torch.stack([xc0 * inv - m[0], xc1 * inv - m[1]], dim=0)


def pinhole_project_jacobian_cm(measurement, pose_cm, point_cm):
    """Residual + analytic Jacobian ``(r [2, B], J [2, 9, B])``; tangent
    columns are camera [w, v] then point (derivation in the JAX package's
    ``pinhole_project_jacobian``)."""
    r00, r01, r02 = pose_cm[0], pose_cm[1], pose_cm[2]
    r10, r11, r12 = pose_cm[4], pose_cm[5], pose_cm[6]
    r20, r21, r22 = pose_cm[8], pose_cm[9], pose_cm[10]
    xc0, xc1, xc2 = _camera_frame(pose_cm, point_cm)
    inv = 1.0 / xc2
    u = xc0 * inv
    v = xc1 * inv
    m = measurement.T
    res = torch.stack([u - m[0], v - m[1]], dim=0)
    zero = torch.zeros_like(u)
    row0 = torch.stack(
        [
            u * v, -(1.0 + u * u), xc1 * inv,
            -inv, zero, u * inv,
            (r00 - r02 * u) * inv, (r10 - r12 * u) * inv, (r20 - r22 * u) * inv,
        ],
        dim=0,
    )
    row1 = torch.stack(
        [
            1.0 + v * v, -u * v, -xc0 * inv,
            zero, -inv, v * inv,
            (r01 - r02 * v) * inv, (r11 - r12 * v) * inv, (r21 - r22 * v) * inv,
        ],
        dim=0,
    )
    return res, torch.stack([row0, row1], dim=0)


def make_pinhole_ba(ncameras=8, nlandmarks=64, prop_visible=1.0, seed=1,
                    noise=0.0, robust_width=None, dtype=None, hand_jacobian=False,
                    batched=False, device=None):
    """SE(3)+pinhole BA with ground-truth-generated measurements: cameras on
    a ring of radius 2 looking at the origin, landmarks in a unit cube.
    Returns ``(problem, cameras, landmarks)``.  ``batched`` picks the batch
    form as in the JAX package: ``False`` (per-cost; Jacobians by autodiff,
    or :func:`pinhole_project_jacobian` with ``hand_jacobian``), ``True``
    (row-major, hand Jacobian) or ``"cm"`` (components-major, hand
    Jacobian: the form the port's Schur backends take; the dense and cg
    backends take every form)."""
    rng = np.random.default_rng(seed)
    p = Problem(dtype=dtype, device=device)
    cam_man, lmk_man = SE3(), Euclidean(3)

    def look_at(eye):
        z = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        if np.linalg.norm(x) < 1e-6:
            x = np.array([1.0, 0.0, 0.0])
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        r = np.stack([x, y, z], axis=1)
        return np.concatenate([r, eye[:, None]], axis=1)

    poses = np.stack(
        [
            look_at(
                np.array(
                    [
                        2 * np.cos(2 * np.pi * i / ncameras),
                        2 * np.sin(2 * np.pi * i / ncameras),
                        0.5,
                    ]
                )
            )
            for i in range(ncameras)
        ]
    )  # [C, 3, 4]
    points = rng.random((nlandmarks, 3)) - 0.5
    cameras = p.add_variables(cam_man, poses)
    landmarks = p.add_variables(lmk_man, points)

    vis = _banded_visibility(ncameras, nlandmarks, prop_visible)
    ci, li = np.nonzero(vis)
    r = poses[ci, :, :3]
    t = poses[ci, :, 3]
    xc = np.einsum("kij,ki->kj", r, points[li] - t)  # R^T (X - t)
    meas = xc[:, :2] / xc[:, 2:3] + rng.standard_normal((len(ci), 2)) * noise
    if batched == "cm":
        fn, jacobian = pinhole_project_cm, pinhole_project_jacobian_cm
    elif batched:
        fn, jacobian = pinhole_project_batched, pinhole_project_jacobian_batched
    else:
        fn, jacobian = pinhole_project, pinhole_project_jacobian if hand_jacobian else None
    p.add_cost_batch(
        fn,
        slots=[(cam_man, ci), (lmk_man, li)],
        params=meas,
        kernel=Huber(robust_width) if robust_width else None,
        jacobian=jacobian,
        batched=batched,
    )
    return p, cameras, landmarks
