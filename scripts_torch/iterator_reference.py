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
- ``bench_riders_f32``: bench-realistic in float32 (components-major,
  hand Jacobian) with its 81 lowest-id points fixed (1%) at their true
  values, a prior batch on every camera and one on every 100th free point
  (their true values), the free points perturbed by 0.05 (seed 5), LM
  through ``solver="schur"``
  with the bench options (30 iterations, no early stop).

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
}


def _line(name, r, t0):
    jax.effects_barrier()
    return dict(
        case=name, start=float(r.start_cost), costs=[float(c) for c in r.trajectory.costs],
        best=float(r.best_cost), iterations=int(r.num_iterations),
        solves=int(r.linear_solves), cost_evals=int(r.cost_computations),
        cholesky_to_lu=SOLVES["lu"], nonfinite_solves=SOLVES["nonfinite"],
        counted_solves=SOLVES["total"], seconds=time.perf_counter() - t0,
        **({"pcg_iters": list(PCG_ITERS)} if PCG_ITERS else {}),
    )


def main():
    names = sys.argv[1:] or [*CASES, "curvefit"]
    for name in names:
        SOLVES.update(total=0, lu=0, nonfinite=0)
        PCG_ITERS.clear()
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
