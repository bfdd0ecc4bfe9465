"""How far the JAX package's float64 LM cost trace moves from itself when
its start is scaled by 1 ± 2⁻⁵², beside how far the port's trace lies
from it: the ground of the 1e-9 trace tolerance of the port's parity
tests.  On the CPU:

    JAX_PLATFORMS=cpu python scripts_torch/trace_spread.py [slice] [bal] [adaptive]

``slice``: ``tests/test_torch_slice.py``'s three shapes; ``bal``:
``tests/test_torch_bal.py``'s bucketed shapes with and without a Huber
kernel; ``adaptive``: ``tests/test_torch_adaptive_backends.py``'s adaptive
problems on every backend and batch form, and the two-kernel and implicit
adaptive problems of ``tests/test_torch_adaptive.py``.  Each line prints the JAX
package's (iterations, linear solves, termination) for the three starts,
the port's, the largest relative self-spread of the JAX trace and the
largest relative distance of the port's trace from the unscaled JAX one
(over the iterations both runs reach)."""

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import nllstpu as nt  # noqa: E402
import nllstpu_torch as pt  # noqa: E402

SCALES = (1.0, 1.0 + 2.0**-52, 1.0 - 2.0**-52)


def _jax_run(jp, scale, opts):
    jp = copy.deepcopy(jp)
    for fam in jp._families.values():
        fam.values[:] = fam.values * scale
    return nt.optimize(jp, opts)


def spread(label, make_pair, jopts, topts):
    """Print one case's line; ``make_pair()`` gives a fresh (JAX, port)
    problem pair."""
    jp, tp = make_pair()
    runs = [_jax_run(jp, s, jopts) for s in SCALES]
    r_t = pt.optimize(tp, topts)
    base = np.asarray(runs[0].trajectory.costs)

    def rel(c):
        c = np.asarray(c)
        n = min(len(c), len(base))
        return float(np.max(np.abs(c[:n] - base[:n]) / np.abs(base[:n])))

    print(label, "jax", [(r.num_iterations, r.linear_solves, r.termination) for r in runs],
          "port", (r_t.num_iterations, r_t.linear_solves, r_t.termination),
          f"self-spread {max(rel(r.trajectory.costs) for r in runs):.3e}",
          f"port-jax {rel(r_t.costs):.3e}", flush=True)


def main(which):
    inf = float("inf")
    if "slice" in which:
        import test_torch_slice as ts

        for shape in ts.SHAPES:
            spread(f"slice {shape}", lambda: ts._pair(*shape),
                   nt.Options(solver="schur", schur_family=nt.Euclidean(3),
                              store_trajectory="jit", rel_dcost=1e-6),
                   pt.Options(solver="schur", schur_family=pt.Euclidean(3), rel_dcost=1e-6,
                              max_time=inf))
    if "bal" in which:
        import test_torch_bal as tb

        for shape in sorted(tb.SHAPES):
            for rw in (None, 5.0):
                spread(f"bal {shape} {rw}", lambda: tb._pair(shape, rw),
                       nt.Options(solver="schur", schur_family=tb.jbal.PT, rel_dcost=1e-6,
                                  store_trajectory="jit"),
                       pt.Options(solver="schur", schur_family=tb.tbal.PT, rel_dcost=1e-6,
                                  max_time=inf))
    if "adaptive" in which:
        import test_torch_adaptive_backends as ta

        import test_torch_adaptive as tad

        for case in ta.CASES:
            jo, to = ta.lm_options(case)
            spread(f"adaptive {case}", lambda: ta.pair(case), jo, to)
        opts = dict(max_iters=2, rel_dcost=1e-6, linear_tol=1e-12)
        for label, solver, make in (
            ("two kernel variables", "schur", tad._two_kernel_problems),
            ("4/8 implicit", "schur_cg", lambda: _four_by_eight(tad)),
        ):
            spread(f"adaptive {label}", make,
                   nt.Options(solver=solver, schur_family=tad.jbal.PT, store_trajectory="jit",
                              **opts),
                   pt.Options(solver=solver, schur_family=tad.tbal.PT, max_time=inf, **opts))


def _four_by_eight(tad):
    """``test_implicit_adaptive_matches_jax``'s problem pair."""
    data = tad.jbal.make_synthetic_bal(4, 8)
    tp, _, tpts, _ = tad.tbal.make_bal_problem(data, device="cpu", kernel=tad.CG[2],
                                               kernel_params=tad.CG[1])
    tad.perturb_ba(tp, tpts, 0.01, seed=7)
    jp, _, jpts, _ = tad.jbal.make_bal_problem(data, kernel=tad.CG[0], kernel_params=tad.CG[1])
    tad.jax_perturb_ba(jp, jpts, 0.01, seed=7)
    return jp, tp


if __name__ == "__main__":
    main(sys.argv[1:] or ["slice", "bal", "adaptive"])
