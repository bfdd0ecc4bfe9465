"""The JAX package's reference runs of the Newton, dogleg, gradient-descent
and dense paths of ``chip_smoke.py``, on the CPU.

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
  float64).

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

import nllstpu as nt  # noqa: E402
from nllstpu.core import iterators as jax_iterators  # noqa: E402
from nllstpu.models import bal  # noqa: E402
from nllstpu.models.ba import make_pinhole_ba, perturb_ba  # noqa: E402
from nllstpu.models.curvefit import make_curve_fit  # noqa: E402
from nllstpu.models.posegraph import make_pose_graph  # noqa: E402
from nllstpu.ops import schur as jax_schur  # noqa: E402

#: Solves seen inside the JAX programs: [Cholesky fell to LU, non-finite].
SOLVES = {"total": 0, "lu": 0, "nonfinite": 0}


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
}


def _line(name, r, t0):
    jax.effects_barrier()
    return dict(
        case=name, start=float(r.start_cost), costs=[float(c) for c in r.trajectory.costs],
        best=float(r.best_cost), iterations=int(r.num_iterations),
        solves=int(r.linear_solves), cost_evals=int(r.cost_computations),
        cholesky_to_lu=SOLVES["lu"], nonfinite_solves=SOLVES["nonfinite"],
        counted_solves=SOLVES["total"], seconds=time.perf_counter() - t0,
    )


def main():
    names = sys.argv[1:] or [*CASES, "curvefit"]
    for name in names:
        SOLVES.update(total=0, lu=0, nonfinite=0)
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
