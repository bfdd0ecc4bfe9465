"""Trajectory-space non-rigid structure from motion (NRSfM), a problem
whose eliminated blocks are wider than any unrolled reduction instance,
and the JAX package's CPU references of ``chip_smoke.py``'s phase that
runs it:

    JAX_PLATFORMS=cpu python scripts_torch/anydl_reference.py [case ...]

Each point moves: its trajectory is K DCT-II coefficients per axis
(Akhter, Sheikh, Khan, Kanade, "Trajectory Space: A Dual Representation
for Nonrigid Structure from Motion", TPAMI 2011), so the point is a
``Euclidean(3K)`` variable (axis-major: x's K coefficients, then y's, then
z's) and K = 3 gives dl = 9, K = 6 dl = 18.  The basis spans each point's
own track (its consecutive frames), orthonormal there, as Park, Shiratori,
Matthews and Sheikh's reconstruction of a moving point takes it (ECCV
2010): over the banded pattern a point is seen in 8-14 frames, where a
DCT over the whole 128-frame sequence is singular to float64 (condition
number 3e13 at K = 6).  A track of n frames keeps at most n/2
coefficients per axis (:func:`track_coefficients`: at K = 6, 528 of the
8192 points, seen in 8-11 frames, keep 4 or 5).  Each observation carries its θ_k(j) (j its frame
within the track) in its params, after its measurement.  A frame is a
perspective camera of 6 dof, ``Euclidean(6)``: angle-axis ω and
translation t (P = R(ω)·X + t, Snavely's convention), focal length
:data:`FOCAL` fixed; the residual is f·(P0, P1)/P2 − m (2 rows) with its
hand components-major Jacobian.  Frames look at the scene from random
directions, each a uniform random rotation at depth :data:`DEPTH`: under a
smooth camera path, moving a point along its rays is close to a
trajectory the basis holds, and the problem loses its depth.

Data (:data:`NRSFM`): 128 frames by 8192 points over
``banded_visibility(128, 8192, 0.1)`` (the pinhole bench's pattern,
104,858 observations), measurement noise 0.5 px at f = 500 px, points
perturbed by ``perturb_ba(points, 0.05, seed=5)``.  Nothing is cut: on
the port's generic route W is [8192, 3K, 768].

The residual and Jacobian take the array namespace (``torch`` or
``jax.numpy``) as their first argument, so that the port's runs, the JAX
package's and the tests share one definition; the data are numpy, made
from a seed.  Importing this module imports neither jax nor the JAX
package (``chip_smoke.py`` imports it).

Cases (all by default), each printing one JSON line: ``k3_f32`` and
``k6_f32`` — Levenberg-Marquardt, float32, 30 iterations
(``chip_smoke.py``'s bench options): start and best cost; ``k6_f64`` —
float64 with ``rel_dcost=1e-6``: start cost, the cost after each
iteration, best cost (the trace gate's reference); ``adaptive_k3_f32`` —
the adaptive form (:func:`with_outliers`, one shared ContaminatedGaussian
started at :data:`ADAPTIVE_START`, points perturbed by
:data:`ADAPTIVE_PERTURB`, as the adaptive bench-realistic path), float32,
30 iterations: start and best cost and the kernel's (σ1, σ2, w).  This
script runs the JAX package, not the port.
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from scripts_torch.shapes_reference import _rodrigues, banded_visibility  # noqa: E402

#: The full-size problem: frames, points, visibility.
NRSFM = dict(nframes=128, npoints=8192, vis=0.1)
#: Coefficients per axis of the two full-size cases.
KS = (3, 6)
#: The cameras' fixed focal length (pixels), the measurement noise
#: (pixels), the scene's depth in front of every camera and the trajectory
#: coefficients' spread beyond the first.
FOCAL, NOISE, DEPTH, DEFORM = 500.0, 0.5, 3.0, 0.1
#: LM iterations of the float32 references.
ITERS = 30
#: The adaptive form's kernel start (σ1, σ2, w: the adaptive BAL paths'),
#: its points' perturbation (theirs) and its K.
ADAPTIVE_START, ADAPTIVE_PERTURB, ADAPTIVE_K = (1.0, 10.0, 0.8), 0.01, 3


def dct_basis(n, K):
    """The orthonormal DCT-II basis over ``n`` frames, ``[n, K]``:
    θ_k(j) = √(c_k / n)·cos(π(2j + 1)k / 2n), c_0 = 1, c_k = 2."""
    j, k = np.arange(n)[:, None], np.arange(K)[None, :]
    return np.sqrt(np.where(k == 0, 1.0, 2.0) / n) * np.cos(np.pi * (2 * j + 1) * k / (2 * n))


def track_coefficients(n, K):
    """The coefficients per axis that a track of ``n`` frames keeps: at
    most K, and one for every two frames (its 2n measurements then hold
    the 3k unknowns with n/2 to spare).  A shorter track's higher θ_k are
    0, so that its point keeps 3K dof whose extra ones no cost reaches
    (their gradient and coupling exactly 0)."""
    return min(K, n // 2)


def nrsfm_model(xp, K, focal=FOCAL):
    """``(residual, jacobian)`` of the NRSfM cost in namespace ``xp``:
    ``cam [6, B]`` (ω, t), ``pt [3K, B]`` (axis-major coefficients),
    ``meas [B, 2 + K]`` (u, v, then θ_0..θ_{K−1} of the observation's
    frame) → ``r [2, B]``, ``J [2, 6 + 3K, B]`` (camera tangent, then the
    coefficients; the rotation's chain is the packages'
    ``snavely_jacobian_cm``'s)."""

    def position(meas, pt):
        th = meas.T[2:]
        return [(th * pt[a * K : (a + 1) * K]).sum(0) for a in range(3)], th

    def rotate(cam, x):
        w0, w1, w2 = cam[0], cam[1], cam[2]
        x0, x1, x2 = x
        a, s, c, big_a, big_b = _rodrigues(xp, w0 * w0 + w1 * w1 + w2 * w2)
        wx = w1 * x2 - w2 * x1
        wy = w2 * x0 - w0 * x2
        wz = w0 * x1 - w1 * x0
        wdx = w0 * x0 + w1 * x1 + w2 * x2
        p = (x0 * a + wx * s + w0 * wdx * c + cam[3],
             x1 * a + wy * s + w1 * wdx * c + cam[4],
             x2 * a + wz * s + w2 * wdx * c + cam[5])
        return p, (a, s, c, big_a, big_b, wx, wy, wz, wdx)

    def residual(meas, cam, pt):
        x, _ = position(meas, pt)
        (p0, p1, p2), _ = rotate(cam, x)
        m = meas.T
        return xp.stack([focal * p0 / p2 - m[0], focal * p1 / p2 - m[1]])

    def jacobian(meas, cam, pt):
        x, th = position(meas, pt)
        (p0, p1, p2), (a, s, c, big_a, big_b, wx, wy, wz, wdx) = rotate(cam, x)
        w0, w1, w2 = cam[0], cam[1], cam[2]
        x0, x1, x2 = x
        inv = 1.0 / p2
        m = meas.T
        zero = xp.zeros_like(p2)
        rows = []
        for q in ((focal * inv, zero, -focal * p0 * inv * inv),
                  (zero, focal * inv, -focal * p1 * inv * inv)):
            q0, q1, q2 = q
            qdw = q0 * w0 + q1 * w1 + q2 * w2
            qdx = q0 * x0 + q1 * x1 + q2 * x2
            qdwx = q0 * wx + q1 * wy + q2 * wz
            coef = -s * qdx + big_a * qdwx + big_b * wdx * qdw
            jw = [s * (x1 * q2 - x2 * q1) + c * (wdx * q0 + qdw * x0) + coef * w0,
                  s * (x2 * q0 - x0 * q2) + c * (wdx * q1 + qdw * x1) + coef * w1,
                  s * (x0 * q1 - x1 * q0) + c * (wdx * q2 + qdw * x2) + coef * w2]
            jx = [a * q0 + s * (q1 * w2 - q2 * w1) + c * qdw * w0,
                  a * q1 + s * (q2 * w0 - q0 * w2) + c * qdw * w1,
                  a * q2 + s * (q0 * w1 - q1 * w0) + c * qdw * w2]
            rows.append(xp.stack(jw + list(q) + [jx[ax] * th[k] for ax in range(3)
                                                 for k in range(K)]))
        res = xp.stack([focal * p0 / p2 - m[0], focal * p1 / p2 - m[1]])
        return res, xp.stack(rows)

    return residual, jacobian


def _random_rotations(rng, n):
    """``n`` angle-axis vectors of uniform random rotations (from unit
    quaternions with a non-negative real part: angles in [0, π])."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.where(q[:, :1] < 0, -1.0, 1.0)
    half = np.arccos(np.clip(q[:, 0], -1.0, 1.0))
    scale = np.where(half > 1e-12, 2.0 * half / np.maximum(np.sin(half), 1e-300), 2.0)
    return q[:, 1:] * scale[:, None]


def _rotate(omega, x):
    """Rodrigues: R(ω)·x for rows of ``omega`` and ``x`` [n, 3] (numpy)."""
    theta = np.linalg.norm(omega, axis=1, keepdims=True)
    k = omega / np.maximum(theta, 1e-300)
    cos, sin = np.cos(theta), np.sin(theta)
    return (x * cos + np.cross(k, x) * sin
            + k * (k * x).sum(1, keepdims=True) * (1.0 - cos))


def nrsfm_data(nframes, npoints, vis, K, noise=NOISE, seed=17):
    """The NRSfM problem's arrays: ``cameras [F, 6]``, ``points [P, 3K]``
    (the ground-truth trajectories' coefficients: a base point in the unit
    cube, then coefficients of spread ``DEFORM / k``), ``cam_idx``,
    ``pt_idx`` over ``banded_visibility(nframes, npoints, vis)`` and
    ``observations [B, 2 + K]`` (the measurement from the ground truth
    plus ``noise``, then the observation's θ)."""
    rng = np.random.default_rng(seed)
    omega = _random_rotations(rng, nframes)
    trans = rng.standard_normal((nframes, 3)) * 0.05 + np.array([0.0, 0.0, DEPTH])
    cameras = np.concatenate([omega, trans], axis=1)
    mask = banded_visibility(nframes, npoints, vis)
    ci, li = np.nonzero(mask)
    first = np.argmax(mask, axis=0)  # each point's first frame (its track is contiguous)
    n_track = mask.sum(0)
    base = rng.random((npoints, 3)) - 0.5
    coef = rng.standard_normal((npoints, 3, K)) * DEFORM / np.maximum(np.arange(K), 1)
    coef[:, :, 0] = base * np.sqrt(n_track)[:, None]
    theta = np.empty((len(ci), K))
    for n in np.unique(n_track):  # one basis per track length
        sel = n_track[li] == n
        basis = dct_basis(n, K)
        basis[:, track_coefficients(n, K):] = 0.0
        theta[sel] = basis[ci[sel] - first[li[sel]]]
        coef[n_track == n, :, track_coefficients(n, K):] = 0.0
    x = np.einsum("bak,bk->ba", coef[li], theta)
    p = _rotate(omega[ci], x) + trans[ci]
    meas = FOCAL * p[:, :2] / p[:, 2:3] + rng.standard_normal((len(ci), 2)) * noise
    return dict(cameras=cameras, points=coef.reshape(npoints, 3 * K), cam_idx=ci.astype(np.int32),
                pt_idx=li.astype(np.int32), observations=np.concatenate([meas, theta], axis=1),
                K=K)


def build(pkg, data, dtype, device=None, adaptive=False):
    """``(problem, cameras, points)`` over ``data`` in package ``pkg``
    (``nllstpu_torch`` or ``nllstpu``), one components-major batch with the
    hand Jacobian; ``device`` for the port only.  ``adaptive``: the batch
    carries one shared ContaminatedGaussian kernel started at
    :data:`ADAPTIVE_START` (σ1, σ2, w), as the adaptive BAL paths' is, and
    the kernel's handle comes fourth."""
    K = data["K"]
    if pkg.__name__ == "nllstpu_torch":
        import torch as xp
        problem = pkg.Problem(dtype=dtype, device=device)
    else:
        import jax.numpy as xp
        problem = pkg.Problem(dtype=dtype)
    cam_m, pt_m = pkg.Euclidean(6), pkg.Euclidean(3 * K)
    residual, jacobian = nrsfm_model(xp, K)
    cams = problem.add_variables(cam_m, data["cameras"])
    pts = problem.add_variables(pt_m, data["points"])
    slots, kernel, kh = [(cam_m, data["cam_idx"]), (pt_m, data["pt_idx"])], None, None
    if adaptive:
        kernel = pkg.ContaminatedGaussian()
        kh = problem.add_variable(kernel.manifold,
                                  pkg.ContaminatedGaussian.make_params(*ADAPTIVE_START))
        slots = [(kernel.manifold, np.full(len(data["pt_idx"]), kh.index, np.int32))] + slots
    problem.add_cost_batch(residual, slots=slots, params=np.asarray(data["observations"]),
                           kernel=kernel, jacobian=jacobian, batched="cm")
    return (problem, cams, pts, kh) if adaptive else (problem, cams, pts)


def with_outliers(data):
    """``data`` with the adaptive paths' outliers: 10% of the observations'
    measurements (u, v; not their θ) moved by 50 pixels
    (``numpy.random.default_rng(3)``), as ``chip_smoke.with_outliers`` moves
    the BAL paths'."""
    rng = np.random.default_rng(3)
    out = rng.choice(len(data["pt_idx"]), size=len(data["pt_idx"]) // 10, replace=False)
    data = dict(data, observations=np.array(data["observations"]))
    data["observations"][out, :2] += 50.0
    return data


def full_data(K):
    """The full-size data with ``K`` coefficients per axis."""
    return nrsfm_data(**NRSFM, K=K)


def _jax_case(name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import nllstpu as nt
    from nllstpu.models.ba import perturb_ba

    adaptive = name.startswith("adaptive_")
    k, prec = name.removeprefix("adaptive_").split("_")
    K = int(k[1:])
    dtype = jnp.float32 if prec == "f32" else jnp.float64
    if adaptive:
        problem, _, pts, kh = build(nt, with_outliers(full_data(K)), dtype, adaptive=True)
        perturb_ba(problem, pts, ADAPTIVE_PERTURB, seed=5)
    else:
        problem, _, pts = build(nt, full_data(K), dtype)
        perturb_ba(problem, pts, 0.05, seed=5)
    fam = nt.Euclidean(3 * K)
    if prec == "f32":
        opts = nt.Options(max_iters=ITERS, rel_dcost=0.0, abs_dcost=0.0, dstep=1e-12,
                          max_fails=1 << 30, max_time=float("inf"), solver="schur",
                          schur_family=fam)
    else:
        opts = nt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                          max_time=float("inf"), store_trajectory="jit")
    t0 = time.perf_counter()
    r = nt.optimize(problem, opts)
    out = dict(case=name, start=float(r.start_cost), best=float(r.best_cost),
               iterations=int(r.num_iterations), seconds=time.perf_counter() - t0)
    if prec == "f64":
        out["costs"] = [float(c) for c in np.asarray(r.trajectory.costs)]
    if adaptive:
        out["sigmas_weight"] = [float(x) for x in np.asarray(
            nt.ContaminatedGaussian.sigmas_weight(problem.get_value(kh)))]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    for case in sys.argv[1:] or ["k3_f32", "k6_f32", "k6_f64", "adaptive_k3_f32"]:
        _jax_case(case)
