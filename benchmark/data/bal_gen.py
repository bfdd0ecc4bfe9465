"""BAL-shaped data made from a seed (numpy only).

Derived from the realistic BAL generator that ``nllstpu_torch.models.bal``
carries (``make_realistic_bal``, ``_ring_cameras``, ``_project_ground_truth``):
power-law track lengths, a lognormal camera popularity, Snavely cameras on a
ring; here each track's cameras are drawn from the whole ring, so that a
point is triangulated over wide baselines and pixel-level noise leaves the
problem well posed.  It lives here so that a change to the port's model file
cannot move the yardstick.

The structure, the ground truth, the measurement noise and the pool of start
values come from the configuration's own ``structure_seed``, as a published
data set is fixed: every run of a configuration has the same problem and the
same set of solves, and the benchmark's ``--seed`` draws their order.
"""

from __future__ import annotations

import numpy as np


def project_ground_truth(cameras, points, cam_idx, pt_idx):
    """Noise-free Snavely projections: P = R·X + t, p = −P.xy/P.z, scaled
    by f·(1 + k1·r² + k2·r⁴)."""
    w = cameras[cam_idx, :3]
    t = cameras[cam_idx, 3:6]
    x = points[pt_idx]
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    theta = np.where(theta < 1e-12, 1e-12, theta)
    axis = w / theta
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    p = (
        x * cos_t
        + np.cross(axis, x) * sin_t
        + axis * (np.sum(axis * x, axis=1, keepdims=True) * (1 - cos_t))
        + t
    )
    xp = -p[:, :2] / p[:, 2:3]
    r2 = np.sum(xp * xp, axis=1, keepdims=True)
    f = cameras[cam_idx, 6:7]
    k1 = cameras[cam_idx, 7:8]
    k2 = cameras[cam_idx, 8:9]
    return f * (1.0 + r2 * (k1 + k2 * r2)) * xp


def ring_cameras(rng, ncameras):
    """Cameras on a ring of radius 4 with small random rotations."""
    cameras = np.zeros((ncameras, 9))
    for i in range(ncameras):
        ang = 2 * np.pi * i / ncameras
        cameras[i, :3] = rng.standard_normal(3) * 0.05
        center = np.array([4 * np.cos(ang), 4 * np.sin(ang), 1.0])
        cameras[i, 3:6] = -center  # t = -R·C ≈ -C for small rotations
        cameras[i, 6] = 500.0 + rng.random() * 100
        cameras[i, 7:9] = rng.standard_normal(2) * 1e-7
    return cameras


def track_cameras(rng, track_len, cam_w, min_arc_deg, chunk=8192):
    """Each track's cameras, drawn by popularity ``cam_w`` without
    replacement (Gumbel top-k, ``chunk`` points at a time): a first camera,
    then the others from the whole ring less the arc of ``min_arc_deg``
    either side of the first, so that every point is seen over a baseline
    (12° of a ring of radius 4 under a blob 9 units up: ~5° of
    triangulation) as structure from motion keeps only triangulated points.
    Returned in ascending order, tracks one after another."""
    ncam = cam_w.shape[0]
    kmax = int(track_len.max())
    near = min(int(np.ceil(ncam * min_arc_deg / 360.0)), (ncam - kmax + 2) // 2)
    logw = np.log(cam_w)
    ring = np.arange(ncam)
    out = []
    for a in range(0, track_len.shape[0], chunk):
        k = track_len[a:a + chunk]
        with np.errstate(divide="ignore"):
            keys = logw - np.log(-np.log(rng.random((k.shape[0], ncam))))
        first = np.argmax(keys, axis=1)
        gap = np.abs(ring - first[:, None])
        keys[np.minimum(gap, ncam - gap) < near] = -np.inf
        keys[np.arange(k.shape[0]), first] = np.inf
        top = np.argpartition(-keys, kmax - 1, axis=1)[:, :kmax]
        top = np.take_along_axis(top, np.argsort(-np.take_along_axis(keys, top, 1), axis=1), 1)
        held = np.arange(kmax) < k[:, None]
        picked = np.sort(np.where(held, top, ncam), axis=1)
        out.append(picked[held])
    return np.concatenate(out).astype(np.int32)


def structure(ncameras, npoints, seed, track_alpha, max_track=None, cam_skew=1.0,
              spread=(0.5, 0.5, 0.5), min_arc_deg=0.0) -> dict:
    """The ground truth and the observation pattern: track lengths P(k) ∝
    k^-``track_alpha`` on [2, ``max_track``] (at most 48 and the camera
    count), each track's cameras drawn by a lognormal(σ=``cam_skew``)
    popularity from the whole ring (:func:`track_cameras`); cameras on a
    ring, points in a blob in front of them.  The track lengths, the
    popularity, the cameras and the points are the port's generator's
    draws; its tracks held contiguous cameras 0.1 units apart, whose depths
    pixel-level noise leaves unresolved."""
    rng = np.random.default_rng(seed)
    if max_track is None:
        max_track = min(ncameras, 48)
    max_track = min(max_track, ncameras)
    ks = np.arange(2, max_track + 1)
    pk = ks.astype(np.float64) ** (-track_alpha)
    pk /= pk.sum()
    track_len = rng.choice(ks, size=npoints, p=pk)
    cam_w = rng.lognormal(mean=0.0, sigma=cam_skew, size=ncameras)
    cam_w /= cam_w.sum()
    pt_idx = np.repeat(np.arange(npoints, dtype=np.int32), track_len)
    cam_idx = track_cameras(rng, track_len, cam_w, min_arc_deg)
    cameras = ring_cameras(rng, ncameras)
    points = rng.standard_normal((npoints, 3)) * np.asarray(spread)
    points[:, 2] += 10.0
    return dict(cameras=cameras, points=points, cam_idx=cam_idx, pt_idx=pt_idx,
                clean=project_ground_truth(cameras, points, cam_idx, pt_idx))


def seed_rng(seed: int, *stream) -> np.random.Generator:
    """A generator for ``stream`` of run seed ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def measurements(truth: dict, seed: int, noise_px: float) -> np.ndarray:
    """The observations: the clean projections plus Gaussian pixel noise
    drawn from ``seed``'s stream 0."""
    rng = seed_rng(seed, 0)
    return truth["clean"] + rng.standard_normal(truth["clean"].shape) * noise_px


def start_values(truth: dict, seed: int, key: tuple, perturb: dict):
    """The start named by ``key`` (whole numbers) of seed ``seed``: the ground
    truth with Gaussian noise of the traffic's scales on the points and on
    the cameras' rotation and translation (focal length and distortion start
    at the truth)."""
    rng = seed_rng(seed, 1, *key)
    cams = truth["cameras"].copy()
    pts = truth["points"] + rng.standard_normal(truth["points"].shape) * perturb["points"]
    cams[:, :3] += rng.standard_normal((cams.shape[0], 3)) * perturb["rotation"]
    cams[:, 3:6] += rng.standard_normal((cams.shape[0], 3)) * perturb["translation"]
    return cams, pts
