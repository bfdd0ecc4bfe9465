"""The JAX package's reference runs of the Newton, dogleg, gradient-descent,
dense, cg and generic-Schur paths of ``chip_smoke.py``, on the CPU.

    JAX_PLATFORMS=cpu python scripts_torch/iterator_reference.py [case ...]

Cases (all by default), each with ``chip_smoke.py``'s problem and options
(the pinhole bench ``make_pinhole_ba(128, 8192, prop_visible=0.1,
noise=1e-3)`` with ``perturb_ba(points, 0.05, seed=5)``; 30 iterations, no
early stop, ``dstep=1e-12``; the direct Schur path with ``NLLSTPU_W_IMPL``
unset):

- ``newton_gauge_f64``, ``dogleg_gauge_f64``: float64, the first two
  cameras fixed (``unfixed=cams[2:] + lmks``);
- ``newton_gauge_f32``: the same in float32;
- ``dogleg_f32``, ``gd_f32``: float32, every variable free;
- ``dogleg_implicit``: bench-realistic (``make_realistic_bal(128, 8192,
  seed=1, noise=1e-3, track_alpha=1.6, max_track=96)``) in float32 through
  ``solver="schur_cg"`` with ``linear_tol=1e-2``;
- ``curvefit``: ``make_curve_fit`` under each fixed kernel (None, Huber,
  GemanMcclure, Cauchy, Welsch, Tukey at width 0.5), LM in float64 with
  the default options;
- ``posegraph_lm``, ``posegraph_dogleg``: ``make_pose_graph`` at the
  public parking-garage pose graph's counts (1,661 poses, 6,275 edges:
  ``n_loops=4614``), ``noise=0.01``, float64, pose 0 fixed, ``solver=
  "dense"``, 20 iterations, ``rel_dcost=1e-12``;
- ``posegraph_cg_lm``, ``posegraph_cg_dogleg``: the same through
  ``solver="cg"`` (the matrix-free PCG, its default tolerance: 1e-14 in
  float64);
- ``ladybug_percost_lm``, ``ladybug_percost_cg``: Ladybug-49
  (``make_realistic_bal(49, 7776, seed=1, noise=1e-3, track_alpha=2.3)``,
  34,619 observations) in the per-cost form (``make_bal_problem(...,
  batched=False)``, autodiff Jacobians) in float64, a prior batch on every
  25th point from the fourth on (its true position), the first camera and
  the first three points fixed at their true values, the free points
  perturbed by 0.05 (seed 5); LM
  with ``rel_dcost=1e-6`` through ``solver="schur"`` and
  ``solver="schur_cg"`` with ``linear_tol=1e-8`` (the case also prints
  the PCG iterations of every damped solve: at 1e-10 and at the float64
  default, 1e-12, the eighth solve's count moves with last-bit rounding);
- ``adaptive_dubrovnik_implicit``, ``adaptive_bench_implicit``: the
  Dubrovnik-class data (``make_realistic_bal(356, 226730, seed=1,
  noise=1e-3, track_alpha=2.0)``, 1,253,547 observations) or
  bench-realistic's, 10% of the observations moved by 50 pixels, one
  shared ContaminatedGaussian (1, 10, 0.8), the points perturbed by 0.01
  (seed 5), float32, ``solver="schur_cg"``, ``linear_tol=1e-2``;
  ``DUBROVNIK_ITERS`` (default 2, or the environment's) and 60 LM
  iterations without early stop (they print the recovered (σ1, σ2, w));
  ``adaptive_dubrovnik_implicit_f64`` the same in float64 (~12 GiB): the
  float32 run's first iteration's cost lies 1.3e-3 from it (float32 sums
  over the kernel's one run of 1,253,547 rows);
- ``ladybug_adaptive_lm``, ``ladybug_adaptive_cg``,
  ``ladybug_per_camera_lm``: Ladybug-49 with that outlier recipe in
  float64, one shared kernel in the per-cost form or one kernel per camera
  in a components-major batch, the first camera and three points fixed,
  LM with ``rel_dcost=1e-6`` (at most ``LADYBUG_ITERS`` iterations)
  through ``schur`` or ``schur_cg`` (``linear_tol=1e-8``);
- ``mixture_dense``, ``mixture_cg``: tests/test_adaptive.py's two-mean
  mixture in float64, LM with ``rel_dcost=1e-6`` through ``dense`` or
  ``cg``;
- ``bench_riders_f32``: bench-realistic in float32 (components-major,
  hand Jacobian) with its 81 lowest-id points fixed (1%) at their true
  values, a prior batch on every camera and one on every 100th free point
  (their true values), the free points perturbed by 0.05 (seed 5), LM
  through ``solver="schur"``
  with the bench options (30 iterations, no early stop).

With ``--spread``, each (adaptive) case runs three times, its start
scaled by 1 and 1 ± ε (2⁻⁵² in float64, 2⁻²³ on the float32 cases), and
prints the largest relative spread of its
cost trace and its spread at each iteration, the three runs' (iterations,
solves, termination) and, per
damped solve, the least and the most PCG iterations of the three.

Each case prints one JSON line: start cost, the cost after every
iteration, the best cost, iterations, linear solves, cost evaluations and
seconds (``repr``-exact floats: the constants ``ITER_REF`` of
``chip_smoke.py``), and, counted inside the JAX programs, how many of its
Cholesky solves fell to LU and how many solves came out non-finite.  This
script runs the JAX package, not the port.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.pop("NLLSTPU_W_IMPL", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import nllstpu as nt  # noqa: E402
from nllstpu.core import iterators as jax_iterators  # noqa: E402
from nllstpu.models import bal  # noqa: E402
from nllstpu.models.ba import make_pinhole_ba, perturb_ba  # noqa: E402
from nllstpu.models.curvefit import make_curve_fit  # noqa: E402
from nllstpu.models.posegraph import make_pose_graph  # noqa: E402
from nllstpu.ops import schur as jax_schur  # noqa: E402

#: Solves seen inside the JAX programs: [Cholesky fell to LU, non-finite].
SOLVES = {"total": 0, "lu": 0, "nonfinite": 0}
#: PCG iterations of every implicit Schur solve, in order.
PCG_ITERS = []


def _record(ok, finite):
    SOLVES["total"] += 1
    SOLVES["lu"] += int(not ok)
    SOLVES["nonfinite"] += int(not finite)


def counting_cholesky_solve(a, b):
    """``nllstpu.core.linearsolver.cholesky_solve``'s arithmetic, and a
    host callback that counts its LU fallbacks and non-finite answers."""
    chol = jnp.linalg.cholesky(a)
    y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(chol, y, lower=True, trans=1)
    ok = jnp.all(jnp.isfinite(jnp.diagonal(chol)))
    out = jax.lax.cond(ok, lambda _: x, lambda _: jnp.linalg.solve(a, b), None)
    jax.debug.callback(_record, ok, jnp.all(jnp.isfinite(out)))
    return out


jax_schur.cholesky_solve = counting_cholesky_solve
jax_iterators.cholesky_solve = counting_cholesky_solve


class _Proxy:
    """``base`` with some attributes replaced."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._base, name)


def _counting_while_loop(cond, body, init):
    """``jax.lax.while_loop`` for ``nllstpu.ops.schur`` (whose one while
    loop is ``SchurCGOps.solve``'s PCG, state ``(x, r, z, p, rz, k)``),
    with a host callback that records the PCG's iteration count."""
    out = jax.lax.while_loop(cond, body, init)
    jax.debug.callback(lambda k: PCG_ITERS.append(int(k)), out[-1], ordered=True)
    return out


jax_schur.jax = _Proxy(jax, lax=_Proxy(jax.lax, while_loop=_counting_while_loop))

BENCH = dict(max_iters=30, rel_dcost=0.0, abs_dcost=0.0, dstep=1e-12, max_fails=1 << 30,
             max_time=float("inf"), store_trajectory="jit")


def _pinhole(dtype):
    p, cams, lmks = make_pinhole_ba(128, 8192, prop_visible=0.1, noise=1e-3, dtype=dtype,
                                    batched="cm")
    perturb_ba(p, lmks, 0.05, seed=5)
    return p, cams, lmks


def _bench_case(iterator, dtype, gauge):
    p, cams, lmks = _pinhole(dtype)
    opts = nt.Options(iterator=iterator, solver="schur", schur_family=nt.Euclidean(3), **BENCH)
    return nt.optimize(p, opts, unfixed=cams[2:] + lmks if gauge else None)


def _implicit():
    data = bal.make_realistic_bal(ncameras=128, npoints=8192, seed=1, noise=1e-3,
                                  track_alpha=1.6, max_track=96)
    p, _, pts = bal.make_bal_problem(data, dtype=jnp.float32)
    perturb_ba(p, pts, 0.05, seed=5)
    opts = nt.Options(iterator=nt.DOGLEG, solver="schur_cg", schur_family=bal.PT,
                      linear_tol=1e-2, **BENCH)
    return nt.optimize(p, opts)


def _posegraph(iterator, solver="dense"):
    p, poses, _ = make_pose_graph(1661, 4614, noise=0.01, dtype=jnp.float64)
    opts = nt.Options(iterator=iterator, solver=solver, max_iters=20, rel_dcost=1e-12,
                      max_time=float("inf"), store_trajectory="jit")
    return nt.optimize(p, opts, unfixed=poses[1:])


def point_prior(measurement, point):
    """A prior on a point: its offset from ``measurement``."""
    return point - measurement


def camera_prior(measurement, camera):
    """A prior on a Snavely camera: its offset from ``measurement``."""
    return camera - measurement


def _ladybug_percost(solver):
    data = bal.make_realistic_bal(ncameras=49, npoints=7776, seed=1, noise=1e-3,
                                  track_alpha=2.3)
    p, cams, pts = bal.make_bal_problem(data, dtype=jnp.float64, batched=False)
    idx = np.arange(3, len(pts), 25)
    p.add_cost_batch(point_prior, slots=[(bal.PT, idx)], params=data["points"][idx])
    perturb_ba(p, pts[3:], 0.05, seed=5)
    opts = nt.Options(solver=solver, schur_family=bal.PT, rel_dcost=1e-6,
                      linear_tol=1e-8 if solver == "schur_cg" else None,
                      max_time=float("inf"), store_trajectory="jit")
    return nt.optimize(p, opts, unfixed=cams[1:] + pts[3:])


def _bench_riders():
    data = bal.make_realistic_bal(ncameras=128, npoints=8192, seed=1, noise=1e-3,
                                  track_alpha=1.6, max_track=96)
    p, cams, pts = bal.make_bal_problem(data, dtype=jnp.float32)
    n_fix = len(pts) // 100
    p.add_cost_batch(camera_prior, slots=[(bal.CAM, np.arange(len(cams)))],
                     params=data["cameras"])
    idx = np.arange(n_fix, len(pts), 100)
    p.add_cost_batch(point_prior, slots=[(bal.PT, idx)], params=data["points"][idx])
    perturb_ba(p, pts[n_fix:], 0.05, seed=5)
    opts = nt.Options(solver="schur", schur_family=bal.PT, **BENCH)
    return nt.optimize(p, opts, unfixed=cams + pts[n_fix:])


#: The recovered kernel parameters (σ1, σ2, w) of the adaptive cases.
SIGMAS = {}
#: The adaptive cases' start is scaled by this before the run
#: (``--spread``: 1 and 1 ± 2⁻⁵², the trace's own rounding spread).
SCALE = [1.0]


def _optimize(p, opts, **kw):
    for fam in p._families.values():
        fam.values[:] = fam.values * SCALE[0]
    return nt.optimize(p, opts, **kw)


def _outliers(data):
    """The adaptive paths' outlier recipe: 10% of the observations moved
    by 50 pixels (``numpy.random.default_rng(3)``)."""
    rng = np.random.default_rng(3)
    out = rng.choice(len(data["pt_idx"]), size=len(data["pt_idx"]) // 10, replace=False)
    data["observations"][out] += 50.0
    return data


CG_PARAMS = (1.0, 10.0, 0.8)


def _record_sigmas(p, handles):
    SIGMAS["sigmas_weight"] = [
        [float(v) for v in nt.ContaminatedGaussian.sigmas_weight(jnp.asarray(p.get_value(h)))]
        for h in handles
    ]


def _adaptive_implicit(dubrovnik, iters, dtype=jnp.float32):
    """The adaptive implicit paths: Dubrovnik-class or bench-realistic data
    with the outlier recipe, one shared ContaminatedGaussian (1, 10, 0.8),
    the points perturbed by 0.01 (seed 5), float32, ``solver="schur_cg"``
    with ``linear_tol=1e-2``, ``iters`` LM iterations without early stop."""
    args = (dict(ncameras=356, npoints=226730, seed=1, noise=1e-3, track_alpha=2.0) if dubrovnik
            else dict(ncameras=128, npoints=8192, seed=1, noise=1e-3, track_alpha=1.6,
                      max_track=96))
    data = _outliers(bal.make_realistic_bal(**args))
    p, _, pts, kh = bal.make_bal_problem(
        data, dtype=dtype, kernel=nt.ContaminatedGaussian(),
        kernel_params=nt.ContaminatedGaussian.make_params(*CG_PARAMS))
    perturb_ba(p, pts, 0.01, seed=5)
    opts = nt.Options(solver="schur_cg", schur_family=bal.PT, linear_tol=1e-2,
                      **dict(BENCH, max_iters=iters))
    r = _optimize(p, opts)
    _record_sigmas(p, [kh])
    return r


def _ladybug_adaptive(solver, per_camera=False):
    """Ladybug-49 with the outlier recipe in float64: the per-cost form
    with one shared ContaminatedGaussian (``make_bal_problem(...,
    batched=False)``), or a components-major batch with one
    ContaminatedGaussian per camera (49 kernel variables); the first camera
    and the first three points fixed at their true values, the free points
    perturbed by 0.05 (seed 5); LM with ``rel_dcost=1e-6``, the implicit
    solve at ``linear_tol=1e-8``."""
    data = _outliers(bal.make_realistic_bal(ncameras=49, npoints=7776, seed=1, noise=1e-3,
                                            track_alpha=2.3))
    kern = nt.ContaminatedGaussian()
    kp = nt.ContaminatedGaussian.make_params(*CG_PARAMS)
    if per_camera:
        p = nt.Problem(dtype=jnp.float64)
        cams = p.add_variables(bal.CAM, data["cameras"])
        pts = p.add_variables(bal.PT, data["points"])
        kh = [p.add_variable(kern.manifold, np.asarray(kp)) for _ in cams]
        p.add_cost_batch(
            bal.snavely_residual_cm,
            [(kern.manifold, np.asarray([h.index for h in kh])[data["cam_idx"]]),
             (bal.CAM, data["cam_idx"]), (bal.PT, data["pt_idx"])],
            params=data["observations"], kernel=kern, jacobian=bal.snavely_jacobian_cm,
            batched="cm")
    else:
        p, cams, pts, kh = bal.make_bal_problem(data, dtype=jnp.float64, batched=False,
                                                kernel=kern, kernel_params=kp)
        kh = [kh]
    perturb_ba(p, pts[3:], 0.05, seed=5)
    opts = nt.Options(solver=solver, schur_family=bal.PT, rel_dcost=1e-6,
                      linear_tol=1e-8 if solver == "schur_cg" else None, max_iters=LADYBUG_ITERS,
                      max_time=float("inf"), store_trajectory="jit")
    r = _optimize(p, opts, unfixed=cams[1:] + pts[3:] + kh)
    _record_sigmas(p, kh[:3])
    return r


def mean_residual(data, mean):
    """tests/test_adaptive.py's residual: a mean's offset from a sample."""
    return mean - data


def _mixture(solver):
    """tests/test_adaptive.py's two-mean mixture (1,000 samples, a fifth
    of them ten times wider, one ContaminatedGaussian from (0.5, 5, 0.6))
    in float64, LM with ``rel_dcost=1e-6`` through ``solver``."""
    rng = np.random.default_rng(1)
    points = np.concatenate([rng.normal(0, 1, 800), rng.normal(0, 10, 200)])
    kern = nt.ContaminatedGaussian()
    p = nt.Problem(dtype=jnp.float64)
    kh = p.add_variable(kern.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6))
    m1 = p.add_variable(nt.Scalar(), 0.0)
    m2 = p.add_variable(nt.Scalar(), 0.0)
    for x in points:
        p.add_cost(mean_residual, (kh, m1), params=x - 1.0, kernel=kern)
        p.add_cost(mean_residual, (kh, m2), params=x + 1.0, kernel=kern)
    r = _optimize(p, nt.Options(solver=solver, rel_dcost=1e-6, max_time=float("inf"),
                                store_trajectory="jit"))
    _record_sigmas(p, [kh])
    return r


KERNELS = ("None", "Huber", "GemanMcclure", "Cauchy", "Welsch", "Tukey")

CASES = {
    "newton_gauge_f64": lambda: _bench_case(nt.NEWTON, jnp.float64, True),
    "newton_gauge_f32": lambda: _bench_case(nt.NEWTON, jnp.float32, True),
    "dogleg_gauge_f64": lambda: _bench_case(nt.DOGLEG, jnp.float64, True),
    "dogleg_f32": lambda: _bench_case(nt.DOGLEG, jnp.float32, False),
    "gd_f32": lambda: _bench_case(nt.GRADIENT_DESCENT, jnp.float32, False),
    "dogleg_implicit": _implicit,
    "posegraph_lm": lambda: _posegraph(nt.LEVENBERG_MARQUARDT),
    "posegraph_dogleg": lambda: _posegraph(nt.DOGLEG),
    "posegraph_cg_lm": lambda: _posegraph(nt.LEVENBERG_MARQUARDT, "cg"),
    "posegraph_cg_dogleg": lambda: _posegraph(nt.DOGLEG, "cg"),
    "ladybug_percost_lm": lambda: _ladybug_percost("schur"),
    "ladybug_percost_cg": lambda: _ladybug_percost("schur_cg"),
    "bench_riders_f32": _bench_riders,
    "adaptive_dubrovnik_implicit": lambda: _adaptive_implicit(True, DUBROVNIK_ITERS),
    "adaptive_dubrovnik_implicit_f64": lambda: _adaptive_implicit(True, DUBROVNIK_ITERS,
                                                                  jnp.float64),
    "adaptive_bench_implicit": lambda: _adaptive_implicit(False, 60),
    "ladybug_adaptive_lm": lambda: _ladybug_adaptive("schur"),
    "ladybug_adaptive_cg": lambda: _ladybug_adaptive("schur_cg"),
    "ladybug_per_camera_lm": lambda: _ladybug_adaptive("schur", per_camera=True),
    "mixture_dense": lambda: _mixture("dense"),
    "mixture_cg": lambda: _mixture("cg"),
}
#: LM iterations of the adaptive Dubrovnik-class reference (float32 on the
#: CPU at 1,253,547 observations) and of the adaptive Ladybug-49 ones.
DUBROVNIK_ITERS = int(os.environ.get("DUBROVNIK_ITERS", 2))
LADYBUG_ITERS = 10


def _line(name, r, t0):
    jax.effects_barrier()
    return dict(
        case=name, start=float(r.start_cost), costs=[float(c) for c in r.trajectory.costs],
        best=float(r.best_cost), iterations=int(r.num_iterations),
        solves=int(r.linear_solves), cost_evals=int(r.cost_computations),
        cholesky_to_lu=SOLVES["lu"], nonfinite_solves=SOLVES["nonfinite"],
        counted_solves=SOLVES["total"], seconds=time.perf_counter() - t0,
        **({"pcg_iters": list(PCG_ITERS)} if PCG_ITERS else {}), **SIGMAS,
    )


def main():
    names = [a for a in sys.argv[1:] if a != "--spread"] or [*CASES, "curvefit"]
    if "--spread" in sys.argv:
        # The adaptive cases at their start scaled by 1 and 1 ± 2⁻⁵²: the
        # largest relative spread of the trace, and each run's counts.
        for name in names:
            runs = []
            eps = 2.0**-23 if name.startswith("adaptive_") else 2.0**-52  # float32 paths
            for scale in (1.0, 1.0 + eps, 1.0 - eps):
                SCALE[0] = scale
                PCG_ITERS.clear()
                r = CASES[name]()
                jax.effects_barrier()
                runs.append((np.asarray(r.trajectory.costs), (r.num_iterations, r.linear_solves,
                             r.termination), list(PCG_ITERS)))
            n = min(len(c) for c, _, _ in runs)
            base = runs[0][0][:n]
            per_it = [float(max(abs(c[i] - base[i]) for c, _, _ in runs) / abs(base[i]))
                      for i in range(n)]
            spread = max(per_it)
            pcg = [p for _, _, p in runs]
            same = pcg[0] and all(len(q) == len(pcg[0]) for q in pcg)
            bounds = dict(pcg_min=[min(c) for c in zip(*pcg)],
                          pcg_max=[max(c) for c in zip(*pcg)]) if same else {}
            print(json.dumps(dict(case=name, self_spread=spread, per_iteration=per_it,
                                  counts=[k for _, k, _ in runs], **bounds)), flush=True)
        SCALE[0] = 1.0
        return
    for name in names:
        SOLVES.update(total=0, lu=0, nonfinite=0)
        PCG_ITERS.clear()
        SIGMAS.clear()
        t0 = time.perf_counter()
        if name == "curvefit":
            best = {}
            for k in KERNELS:
                kernel = None if k == "None" else getattr(nt, k)(0.5)
                p, _, _ = make_curve_fit(kernel=kernel)
                best[k] = float(nt.optimize(p, nt.Options(max_time=float("inf"))).best_cost)
            print(json.dumps(dict(case=name, best=best, seconds=time.perf_counter() - t0)),
                  flush=True)
            continue
        print(json.dumps(_line(name, CASES[name](), t0)), flush=True)


if __name__ == "__main__":
    main()
