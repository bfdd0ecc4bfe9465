"""The JAX package's CPU references of ``chip_smoke.py``'s phase 21
(per-variable alternation and cost-subset views), each run three times
with its start scaled by 1 and 1 ± 2⁻²³ (float32's ulp) to measure the
package's own spread:

    JAX_PLATFORMS=cpu python scripts_torch/item6_reference.py [case ...]

Cases (all by default):

- ``singles_dubrovnik``: the Dubrovnik-class data (``make_realistic_bal(356,
  226730, seed=1, noise=1e-3, track_alpha=2.0)``, 1,253,547 observations)
  in float32, the points perturbed by 0.01 (seed 5), ``optimize_singles(
  targets=PT)`` with LM and the default options.  The targets are solved
  in chunks of ``CHUNK`` points (each lane sees the initial values of every
  other variable, so a chunk's lanes are the whole run's; the chunks bound
  the memory of the vmapped padded rows).
- ``singles_dubrovnik_f64``: the same in float64 with ``rel_dcost=1e-6``
  (the runs stop before the float64 floor; the start scaled by 1 ± 2⁻⁵²):
  every lane's iterations are then fixed by the arithmetic, not by its
  last bits.
- ``singles_bench_newton``: bench-realistic's data (``make_realistic_bal(
  128, 8192, seed=1, noise=1e-3, track_alpha=1.6, max_track=96)``) the
  same way, with Newton.
- ``view_bench``, ``view_pinhole``: ``SubproblemView(solver="schur")`` on
  bench-realistic (points perturbed by 0.01, seed 5) and on the pinhole
  bench (``make_pinhole_ba(128, 8192, prop_visible=0.1, noise=1e-3)``,
  points perturbed by 0.05, seed 5), float32, LM for ``VIEW_ITERS``
  iterations without early stop: the first half of the points selected,
  then the second, then the first again; each swap's start and best cost
  and ``view.cost()`` after it.  bench-realistic's best costs sit at its
  float32 floor, where the package's own runs part by up to 5e-3.

Each run prints one JSON line; the singles cases print the summed
iterations and the final cost, evaluated in float64 at the final float32
values.  This script runs the JAX package, not the port.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import nllstpu as nt  # noqa: E402
from nllstpu.core.singles import optimize_singles  # noqa: E402
from nllstpu.models import bal  # noqa: E402
from nllstpu.models.ba import make_pinhole_ba, perturb_ba  # noqa: E402

SCALES = (1.0, 1.0 + 2.0**-23, 1.0 - 2.0**-23)
CHUNK = 32768
VIEW_ITERS = 20
DUBROVNIK = dict(ncameras=356, npoints=226730, seed=1, noise=1e-3, track_alpha=2.0)
BENCH = dict(ncameras=128, npoints=8192, seed=1, noise=1e-3, track_alpha=1.6, max_track=96)


def _scaled(p, scale):
    for fam in p._families.values():
        fam.values[:] = (fam.values.astype(np.float64) * scale).astype(fam.values.dtype)


def _bal(args, scale, perturb, dtype=jnp.float32):
    data = bal.make_realistic_bal(**args)
    p, cams, pts = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(p, pts, perturb, seed=5)
    _scaled(p, scale)
    return data, p, pts


def _cost64(data, p):
    """The cost in float64 at the problem's (float32) values."""
    q, _, _ = bal.make_bal_problem(data, dtype=jnp.float64)
    q.set_values({k: np.asarray(v, np.float64) for k, v in p.stacked_variables().items()})
    return float(nt.cost(q))


def singles(label, args, iterator, dtype=jnp.float32, scales=SCALES, **kw):
    for scale in scales:
        data, p, pts = _bal(args, scale, 0.01, dtype)
        t0 = time.perf_counter()
        c0 = _cost64(data, p)
        iters = 0
        for i in range(0, len(pts), CHUNK):
            out = optimize_singles(p, nt.Options(iterator=iterator, **kw),
                                   targets=pts[i : i + CHUNK])
            iters += sum(out.values())
        print(json.dumps(dict(case=label, scale=scale, iterations=iters, start_cost64=c0,
                              final_cost64=_cost64(data, p), chunk=CHUNK,
                              seconds=time.perf_counter() - t0)), flush=True)


def singles_dubrovnik():
    singles("singles_dubrovnik", DUBROVNIK, nt.LEVENBERG_MARQUARDT)


def singles_dubrovnik_f64():
    singles("singles_dubrovnik_f64", DUBROVNIK, nt.LEVENBERG_MARQUARDT, jnp.float64,
            (1.0, 1.0 + 2.0**-52, 1.0 - 2.0**-52), rel_dcost=1e-6)


def singles_bench_newton():
    singles("singles_bench_newton", BENCH, nt.NEWTON)


def _view_opts():
    return nt.Options(max_iters=VIEW_ITERS, rel_dcost=0.0, abs_dcost=0.0, dstep=1e-12,
                      max_fails=1 << 30, max_time=float("inf"), solver="schur",
                      schur_family=nt.Euclidean(3))


def view(label, make):
    for scale in SCALES:
        p, pts = make()
        _scaled(p, scale)
        v = nt.SubproblemView(p, solver="schur", schur_family=nt.Euclidean(3))
        half = len(pts) // 2
        swaps = []
        t0 = time.perf_counter()
        for sel in (pts[:half], pts[half:], pts[:half]):
            r = v.select(sel).optimize(_view_opts())
            swaps.append(dict(start=r.start_cost, best=r.best_cost,
                              iterations=r.num_iterations, view_cost=v.cost()))
        print(json.dumps(dict(case=label, scale=scale, swaps=swaps, traces=v.trace_count,
                              seconds=time.perf_counter() - t0)), flush=True)


def view_bench():
    def make():
        _, p, pts = _bal(BENCH, 1.0, 0.01)
        return p, pts

    view("view_bench", make)


def view_pinhole():
    def make():
        p, _, lmks = make_pinhole_ba(128, 8192, prop_visible=0.1, noise=1e-3,
                                     dtype=jnp.float32, batched="cm")
        perturb_ba(p, lmks, 0.05, seed=5)
        return p, lmks

    view("view_pinhole", make)


if __name__ == "__main__":
    for name in sys.argv[1:] or ["singles_bench_newton", "view_pinhole", "view_bench",
                                 "singles_dubrovnik", "singles_dubrovnik_f64"]:
        globals()[name]()
