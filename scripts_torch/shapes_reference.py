"""Two bundle-adjustment shapes that neither package ships, and the JAX
package's CPU references of ``chip_smoke.py``'s phase that runs them:

    JAX_PLATFORMS=cpu python scripts_torch/shapes_reference.py [case ...]

- **planar** (dl = 2): ``tests/test_pallas.py::test_assemble_fused_all_dl2``'s
  residual, an affine camera of 6 dof (a 2x2 matrix and a translation) on
  2-D landmarks, r = A·x + t − m, with its hand components-major Jacobian;
  at the pinhole bench's size, 128 cameras by 8192 landmarks over
  ``_banded_visibility(128, 8192, 0.1)`` (104,864 observations, one
  bucket), the landmarks perturbed by ``perturb_ba(points, 0.05, seed=5)``
  as the bench's are.  Kernel shape (n, dr_s, dl) = (2, 6, 2).
- **stereo** (a third residual row): bench-realistic's cameras, points and
  observation pattern (``make_realistic_bal(128, 8192, seed=1, noise=1e-3,
  track_alpha=1.6, max_track=96)``, 88,536 observations, 7 buckets) with
  u_r, the Snavely projection's first coordinate seen by a right camera
  displaced by ``BASELINE`` along the camera's x axis (the point at P −
  BASELINE·x̂ in the camera frame).  Shape (3, 9, 3).

The residuals and Jacobians take the array namespace (``torch`` or
``jax.numpy``) as their first argument, so that the port's runs, the JAX
package's and the tests share one definition; the data are numpy, made
from a seed.  Importing this module imports neither jax nor the JAX
package (``chip_smoke.py`` imports it).

Cases (all by default), each printing one JSON line:
``planar_f32`` and ``stereo_f32`` — Levenberg-Marquardt, float32, 30
iterations (``chip_smoke.py``'s bench options): start and best cost;
``planar_f64`` — float64 with ``rel_dcost=1e-6``: start cost, the cost
after each iteration, best cost (the trace gate's reference).  This
script runs the JAX package, not the port.
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The planar problem: cameras, landmarks, visibility, measurement noise.
PLANAR = dict(ncam=128, nlmk=8192, vis=0.1, noise=1e-3)
#: The stereo problem's ``make_realistic_bal`` arguments.
STEREO = dict(ncameras=128, npoints=8192, seed=1, noise=1e-3, track_alpha=1.6, max_track=96)
#: The stereo pair's baseline, along the camera's x axis (the scene is
#: ~10 units from the cameras).
BASELINE = 0.3
#: LM iterations of the float32 references.
ITERS = 30


def planar_model(xp):
    """``(residual, jacobian)`` of the planar cost in namespace ``xp``:
    ``cam [6, B]`` (A row-major, then t), ``lmk [2, B]``, ``meas [B, 2]``
    → ``r [2, B]``, ``J [2, 8, B]`` (camera tangent, then landmark)."""

    def residual(meas, cam, lmk):
        m = meas.T
        return xp.stack([cam[0] * lmk[0] + cam[1] * lmk[1] + cam[4] - m[0],
                         cam[2] * lmk[0] + cam[3] * lmk[1] + cam[5] - m[1]])

    def jacobian(meas, cam, lmk):
        z, o = xp.zeros_like(lmk[0]), xp.ones_like(lmk[0])
        j1 = xp.stack([lmk[0], lmk[1], z, z, o, z, cam[0], cam[1]])
        j2 = xp.stack([z, z, lmk[0], lmk[1], z, o, cam[2], cam[3]])
        return residual(meas, cam, lmk), xp.stack([j1, j2])

    return residual, jacobian


def _rodrigues(xp, tt):
    """cos θ, sinc θ, (1 − cos θ)/θ² of θ² = ``tt`` and their θ²
    derivatives' terms, with the guarded series below θ² = 1e-14 (as the
    packages' Snavely residuals)."""
    small = tt < 1e-14
    tts = xp.where(small, xp.ones_like(tt), tt)
    theta = xp.sqrt(tts)
    a = xp.where(small, 1.0 - tt / 2.0, xp.cos(theta))
    s = xp.where(small, 1.0 - tt / 6.0, xp.sin(theta) / theta)
    c = xp.where(small, 0.5 - tt / 24.0, (1.0 - a) / tts)
    big_a = xp.where(small, -1.0 / 3.0 + tt / 30.0, (a - s) / tts)
    big_b = xp.where(small, -1.0 / 12.0 + tt / 180.0, (s - 2.0 * c) / tts)
    return a, s, c, big_a, big_b


def stereo_model(xp, baseline=BASELINE):
    """``(residual, jacobian)`` of the stereo cost in namespace ``xp``:
    ``cam [9, B]`` (Snavely: angle-axis, translation, f, k1, k2), ``pt [3,
    B]``, ``meas [B, 3]`` → ``r [3, B]`` (u, v of the camera, u of the
    right camera), ``J [3, 12, B]`` (camera tangent, then point; the
    derivation of the packages' ``snavely_jacobian_cm``, the right row
    through the same chain since P_right = P − baseline·x̂)."""

    def parts(cam, pt):
        w0, w1, w2 = cam[0], cam[1], cam[2]
        x0, x1, x2 = pt[0], pt[1], pt[2]
        a, s, c, big_a, big_b = _rodrigues(xp, w0 * w0 + w1 * w1 + w2 * w2)
        wx = w1 * x2 - w2 * x1
        wy = w2 * x0 - w0 * x2
        wz = w0 * x1 - w1 * x0
        wdx = w0 * x0 + w1 * x1 + w2 * x2
        p = (x0 * a + wx * s + w0 * wdx * c + cam[3],
             x1 * a + wy * s + w1 * wdx * c + cam[4],
             x2 * a + wz * s + w2 * wdx * c + cam[5])
        return p, (a, s, c, big_a, big_b, wx, wy, wz, wdx)

    def view(p0, p1, p2, f, k1, k2):
        inv = 1.0 / p2
        xp0, xp1 = -p0 * inv, -p1 * inv
        r2 = xp0 * xp0 + xp1 * xp1
        dist = 1.0 + r2 * (k1 + k2 * r2)
        return inv, xp0, xp1, r2, dist

    def residual(meas, cam, pt):
        (p0, p1, p2), _ = parts(cam, pt)
        f, k1, k2 = cam[6], cam[7], cam[8]
        _, xp0, xp1, _, dist = view(p0, p1, p2, f, k1, k2)
        _, xr0, _, _, dist_r = view(p0 - baseline, p1, p2, f, k1, k2)
        m = meas.T
        return xp.stack([f * dist * xp0 - m[0], f * dist * xp1 - m[1],
                         f * dist_r * xr0 - m[2]])

    def jacobian(meas, cam, pt):
        (p0, p1, p2), (a, s, c, big_a, big_b, wx, wy, wz, wdx) = parts(cam, pt)
        w0, w1, w2 = cam[0], cam[1], cam[2]
        x0, x1, x2 = pt[0], pt[1], pt[2]
        f, k1, k2 = cam[6], cam[7], cam[8]

        def row(q0, q1, q2):
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
            return jw, jx

        rows = []
        for shift, comps in ((0.0, (0, 1)), (baseline, (0,))):
            inv, u0, u1, r2, dist = view(p0 - shift, p1, p2, f, k1, k2)
            dd2 = 2.0 * (k1 + 2.0 * k2 * r2)
            g00 = f * (dist + dd2 * u0 * u0)
            g01 = f * dd2 * u0 * u1
            g11 = f * (dist + dd2 * u1 * u1)
            for comp in comps:
                ga, gb, u = (g00, g01, u0) if comp == 0 else (g01, g11, u1)
                q = (-inv * ga, -inv * gb, -inv * (ga * u0 + gb * u1))
                jw, jx = row(*q)
                rows.append(xp.stack(jw + list(q) + [dist * u, f * r2 * u, f * r2 * r2 * u]
                                     + jx))
        return residual(meas, cam, pt), xp.stack(rows)

    return residual, jacobian


def banded_visibility(ncameras, nlandmarks, prop_visible):
    """The packages' ``models/ba.py:_banded_visibility`` (the reference's
    banded mask), copied: numpy only."""
    cams = np.arange(1, ncameras + 1, dtype=np.float64)[:, None]
    centers = np.linspace(2, ncameras - 1, nlandmarks)[None, :]
    dist = np.abs(cams - centers)
    thresh = np.sort(dist.ravel())[int(np.ceil(dist.size * prop_visible)) - 1]
    return dist <= thresh


def planar_data(ncam, nlmk, vis, noise=1e-3, seed=11):
    """The planar problem's arrays: cameras near the identity map
    (``test_assemble_fused_all_dl2``'s draw), standard-normal landmarks,
    the banded observations and their measurements from the ground truth
    plus ``noise``."""
    rng = np.random.default_rng(seed)
    cams = rng.standard_normal((ncam, 6)) * 0.2 + np.array([1.0, 0, 0, 1.0, 0, 0])
    lmks = rng.standard_normal((nlmk, 2))
    ci, li = np.nonzero(banded_visibility(ncam, nlmk, vis))
    a, x = cams[ci], lmks[li]
    meas = np.stack([a[:, 0] * x[:, 0] + a[:, 1] * x[:, 1] + a[:, 4],
                     a[:, 2] * x[:, 0] + a[:, 3] * x[:, 1] + a[:, 5]], axis=1)
    meas = meas + rng.standard_normal(meas.shape) * noise
    return dict(cameras=cams, points=lmks, cam_idx=ci.astype(np.int32),
                pt_idx=li.astype(np.int32), observations=meas)


def stereo_data(data, seed=1, noise=1e-3, baseline=BASELINE):
    """A ``make_realistic_bal`` dict with a third measurement per
    observation: u of the right camera from the ground truth, plus
    ``noise`` (``numpy.random.default_rng(seed + 1)``)."""
    import torch

    _, jac = stereo_model(torch, baseline)
    cam = torch.as_tensor(data["cameras"][data["cam_idx"]].T)
    pt = torch.as_tensor(data["points"][data["pt_idx"]].T)
    zero = torch.zeros(pt.shape[1], 3, dtype=torch.float64)
    u_r = jac(zero, cam, pt)[0][2].numpy()
    rng = np.random.default_rng(seed + 1)
    return dict(data, observations=np.concatenate(
        [data["observations"], (u_r + rng.standard_normal(u_r.shape) * noise)[:, None]],
        axis=1))


def build(pkg, kind, data, dtype, device=None):
    """``(problem, cameras, points)`` of ``kind`` ("planar" or "stereo")
    over ``data`` in package ``pkg`` (``nllstpu_torch`` or ``nllstpu``),
    one components-major batch with the hand Jacobian; ``device`` for the
    port only."""
    is_torch = pkg.__name__ == "nllstpu_torch"
    if is_torch:
        import torch as xp
        problem = pkg.Problem(dtype=dtype, device=device)
    else:
        import jax.numpy as xp
        problem = pkg.Problem(dtype=dtype)
    cam_m, pt_m = ((pkg.Euclidean(6), pkg.Euclidean(2)) if kind == "planar"
                   else (pkg.Euclidean(9), pkg.Euclidean(3)))
    model = planar_model if kind == "planar" else stereo_model
    residual, jacobian = model(xp)
    cams = problem.add_variables(cam_m, data["cameras"])
    pts = problem.add_variables(pt_m, data["points"])
    problem.add_cost_batch(
        residual, slots=[(cam_m, data["cam_idx"]), (pt_m, data["pt_idx"])],
        params=np.asarray(data["observations"]), jacobian=jacobian, batched="cm",
    )
    return problem, cams, pts


def full_data(kind):
    """The full-size data of ``kind``: :data:`PLANAR` or :data:`STEREO`."""
    if kind == "planar":
        return planar_data(**PLANAR)
    sys.path[:0] = [str(ROOT)]
    from nllstpu_torch.models.bal import make_realistic_bal

    return stereo_data(make_realistic_bal(**STEREO))


def _jax_case(name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path[:0] = [str(ROOT)]
    import nllstpu as nt
    from nllstpu.models.ba import perturb_ba

    kind, prec = name.split("_")
    dtype = jnp.float32 if prec == "f32" else jnp.float64
    problem, _, pts = build(nt, kind, full_data(kind), dtype)
    perturb_ba(problem, pts, 0.05, seed=5)
    fam = nt.Euclidean(2 if kind == "planar" else 3)
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    for case in sys.argv[1:] or ["planar_f32", "planar_f64", "stereo_f32"]:
        _jax_case(case)
