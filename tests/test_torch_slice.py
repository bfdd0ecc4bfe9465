"""The PyTorch port's first slice against the JAX package, end to end on
the CPU in float64: problem arrays, the assembled Schur system, the damped
solve, and the Levenberg-Marquardt cost trace (held to 1e-9 relative)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models.ba import make_pinhole_ba as jax_make_ba
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
import nllstpu_torch as pt
from nllstpu_torch.interop import problem_from_arrays
from nllstpu_torch.models.ba import (
    make_pinhole_ba,
    perturb_ba,
    pinhole_project_cm,
    pinhole_project_jacobian_cm,
)

REPO = pathlib.Path(__file__).resolve().parents[1]

#: (ncameras, nlandmarks, prop_visible, noise, robust_width): the 8/64
#: flagship shape, and a banded one whose W has structural zeros (with
#: and without a Huber kernel in its linear regime).
SHAPES = [
    (8, 64, 1.0, 1e-3, None),
    (16, 256, 0.3, 1e-3, None),
    (16, 256, 0.3, 1e-3, 5e-3),
]


def _pair(ncam, nlmk, vis, noise, robust, perturb=0.01):
    jp, _, jl = jax_make_ba(
        ncam, nlmk, vis, noise=noise, robust_width=robust,
        dtype=jnp.float64, batched="cm",
    )
    jax_perturb_ba(jp, jl, perturb, seed=5)
    tp, _, tl = make_pinhole_ba(
        ncam, nlmk, vis, noise=noise, robust_width=robust, dtype=torch.float64,
        batched="cm", device="cpu",
    )
    perturb_ba(tp, tl, perturb, seed=5)
    return jp, tp


def _arrays(problem):
    """Stacked variables and the padded batch arrays of either package."""
    vars_ = {k: np.asarray(v) for k, v in problem.stacked_variables().items()}
    (b,) = problem.batches()
    return vars_, [np.asarray(i) for i in b.idx], np.asarray(b.params), np.asarray(b.mask)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_make_pinhole_ba_arrays_identical(shape):
    jp, tp = _pair(*shape)
    jv, jidx, jpar, jmask = _arrays(jp)
    tv, tidx, tpar, tmask = _arrays(tp)
    assert jv.keys() == tv.keys()
    for k in jv:
        assert np.array_equal(jv[k], tv[k]), k
    for a, b in zip(jidx, tidx):
        assert np.array_equal(a, b)
    assert np.array_equal(jpar, tpar)
    assert np.array_equal(jmask, tmask)


def test_problem_from_arrays_round_trips():
    jp, tp = _pair(*SHAPES[1])
    jv, jidx, jpar, jmask = _arrays(jp)
    (jb,) = jp.batches()
    rp = problem_from_arrays(
        jv,
        [dict(
            fn=pinhole_project_cm, jacobian=pinhole_project_jacobian_cm,
            manifolds=(pt.SE3(), pt.Euclidean(3)), idx=jidx, params=jpar,
            mask=jmask,
        )],
        dtype=torch.float64, device="cpu",
    )
    rv, ridx, rpar, rmask = _arrays(rp)
    tv, tidx, tpar, tmask = _arrays(tp)
    for k in tv:
        assert np.array_equal(rv[k], tv[k]), k
    for a, b, c in zip(ridx, tidx, jidx):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert np.array_equal(rpar, jpar) and np.array_equal(rmask, jmask)
    assert rp.batches()[0].n == jb.n


@pytest.mark.parametrize("shape", SHAPES)
def test_assembly_and_solve_match_jax(shape):
    """The port's assembled system (kernel B1's plain version on the CPU)
    and damped solve (kernel B3's plain version) against the JAX package's
    one-hot XLA assembly and einsum solve."""
    jp, tp = _pair(*shape, perturb=0.03)
    jc = jax_compile(jp, solver="schur", schur_family=nt.Euclidean(3))
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    tc = pt.compile_problem(tp, solver="schur", schur_family=pt.Euclidean(3))
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    tol = dict(rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-13)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)
    np.testing.assert_allclose(
        sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), **tol
    )
    for lam in (1e-3, 1.0):  # λ = 0 is singular: BA has a 7-dof gauge
        x_j = np.asarray(jc.schur_info.ops().solve(sys_j, jnp.asarray(lam)))
        x_t = tc.ctx().linops.solve(sys_t, lam).numpy()
        np.testing.assert_allclose(x_t, x_j, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(
        tc.ctx().linops.grad(sys_t).numpy(),
        np.asarray(jc.schur_info.ops().grad(sys_j)), **tol,
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_lm_trace_matches_jax(shape):
    """Levenberg-Marquardt through the direct Schur solve: same iteration
    count and a per-iteration cost trace within 1e-9 relative.
    ``rel_dcost=1e-6`` ends both runs before the float64 floor: with the
    default 1e-15 the last check compares best costs one ulp apart, and
    rounding alone decides whether ``TERM_RELDCOST`` is set.  There the
    JAX package moves from itself by at most 4.8e-15 of its trace when its
    start is scaled by 1 ± 2⁻⁵², its counts unchanged
    (``scripts_torch/trace_spread.py slice``).  ``max_time`` is lifted, so
    that the run ends by its tests and not by the host's speed."""
    jp, tp = _pair(*shape)
    r_j = nt.optimize(
        jp, nt.Options(solver="schur", schur_family=nt.Euclidean(3),
                       store_trajectory="jit", rel_dcost=1e-6),
    )
    r_t = pt.optimize(tp, pt.Options(solver="schur", schur_family=pt.Euclidean(3),
                                     rel_dcost=1e-6, max_time=float("inf")))
    counts = [(r.num_iterations, r.linear_solves, r.termination, r.time_total) for r in (r_t, r_j)]
    msg = f"(iterations, solves, termination, seconds) port, jax: {counts}"
    assert counts[0][:3] == counts[1][:3], msg
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12, err_msg=msg)
    np.testing.assert_allclose(
        r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9, err_msg=msg
    )
    np.testing.assert_allclose(r_t.best_cost, r_j.best_cost, rtol=1e-9, err_msg=msg)
    for name, v in tp.stacked_variables().items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(jp.stacked_variables()[name]),
            rtol=1e-6, atol=1e-8,
        )


def test_port_does_not_import_jax():
    code = (
        "import sys\n"
        "import nllstpu_torch, nllstpu_torch.interop, nllstpu_torch.models.ba\n"
        "import nllstpu_torch.models.bal\n"
        "import nllstpu_torch.models.rosenbrock, nllstpu_torch.models.curvefit\n"
        "import nllstpu_torch.models.simple_error, nllstpu_torch.models.posegraph\n"
        "import nllstpu_torch.ops.schur, nllstpu_torch.ops._build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'nllstpu' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env)
