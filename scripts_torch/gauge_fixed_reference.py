"""The JAX package's reference run of the gauge-fixed float64 pinhole path
of ``chip_smoke.py``, on the CPU.

    JAX_PLATFORMS=cpu python scripts_torch/gauge_fixed_reference.py

``make_pinhole_ba(128, 8192, prop_visible=0.1, noise=1e-3)`` in float64,
``perturb_ba(points, 0.05, seed=5)``, the first two cameras fixed
(``unfixed=cams[2:] + lmks``), and ``nt.optimize`` with the options of
``chip_smoke.bench_options`` (30 iterations, no early stop) through the
default direct Schur path (``NLLSTPU_W_IMPL`` unset).  Prints the start
cost, the cost after every iteration, the best cost and the iteration
count, each with ``repr`` (the constants ``GAUGE_REF`` of
``chip_smoke.py``).  This script runs the JAX package, not the port.
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
from nllstpu.models.ba import make_pinhole_ba, perturb_ba  # noqa: E402


def main():
    p, cams, lmks = make_pinhole_ba(
        128, 8192, prop_visible=0.1, noise=1e-3, dtype=jnp.float64, batched="cm",
    )
    perturb_ba(p, lmks, 0.05, seed=5)
    opts = nt.Options(
        max_iters=30, rel_dcost=0.0, abs_dcost=0.0, dstep=1e-12,
        max_fails=1 << 30, max_time=float("inf"), solver="schur",
        schur_family=nt.Euclidean(3), store_trajectory="jit",
    )
    t0 = time.perf_counter()
    r = nt.optimize(p, opts, unfixed=cams[2:] + lmks)
    print(json.dumps(dict(
        start=float(r.start_cost),
        costs=[float(c) for c in r.trajectory.costs],
        best=float(r.best_cost),
        iterations=int(r.num_iterations),
        seconds=time.perf_counter() - t0,
    )))


if __name__ == "__main__":
    main()
