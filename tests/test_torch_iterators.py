"""Newton, dogleg and gradient descent in the port against the JAX
package, on the CPU in float64: the linear-system protocol that dogleg
adds (``SchurOps.quad`` and ``solve0_quad_grad``, ``SchurCGOps.quad``),
the three iterators on the gauge-fixed flagship through the direct Schur
path and dogleg on the implicit one, the initial trust radius and step
size, and the graph driver's pieces against ``run_loop`` bit for bit.

The flagship is ``__graft_entry__._flagship``'s size: 8 cameras, 64
landmarks, all visible, ``perturb_ba(points, 0.01, seed=5)``; gauge-fixed
with its first two cameras fixed (the dual-sorted route's test problem),
where Newton's λ = 0 step is well posed.  Tolerances: the protocol's
values within 1e-12 of the largest entry (the same float64 arithmetic,
summed in another order); the direct paths' traces within 1e-10 relative
per iteration with the same iteration, solve and cost-evaluation counts;
the implicit dogleg (free gauge: the λ = 0 reduced system is singular
along BA's gauge, and PCG's answer there depends on its rounding) within
1e-8 relative per iteration at ``linear_tol=1e-10``, with the same
iterations and solves.  The runs stop before the float64 rounding floor
(``rel_dcost``)."""

import dataclasses

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
from nllstpu_torch.core.optimize import compile_problem, run_graphs, run_loop, run_stepped
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
from nllstpu_torch.models.posegraph import make_pose_graph

FLAGSHIP = dict(ncameras=8, nlandmarks=64, prop_visible=1.0, noise=1e-3)
ITERATORS = (pt.NEWTON, pt.DOGLEG, pt.GRADIENT_DESCENT)


def _pair(gauge=True):
    """The flagship in both packages, and each one's ``unfixed``."""
    jp, jc, jl = jax_make_ba(**FLAGSHIP, dtype=jnp.float64, batched="cm")
    jax_perturb_ba(jp, jl, 0.01, seed=5)
    tp, tc, tl = make_pinhole_ba(**FLAGSHIP, dtype=torch.float64, batched="cm", device="cpu")
    perturb_ba(tp, tl, 0.01, seed=5)
    if not gauge:
        return (jp, None), (tp, None)
    return (jp, jc[2:] + jl), (tp, tc[2:] + tl)


def _opts(pkg, **kw):
    return pkg.Options(**{"solver": "schur", "schur_family": pkg.Euclidean(3),
                          "rel_dcost": 1e-10, "max_iters": 20, **kw})


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-12 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("solver", ["schur", "schur_cg"])
def test_linear_system_protocol_matches_jax(solver):
    """``quad`` at the gradient and at a random vector, and on the direct
    path ``solve0_quad_grad`` (the undamped solve fused with gᵀHg) and its
    capture-safe ``leg_ex`` (Cholesky; LU), on one assembled system of
    the gauge-fixed flagship (the implicit path: free, which it requires)
    against the JAX package's functions."""
    (jp, ju), (tp, tu) = _pair(gauge=solver == "schur")
    jc = jax_compile(jp, ju, solver=solver, schur_family=nt.Euclidean(3))
    ops_j = jc.ctx(nt.Options(linear_tol=1e-12)).ops()
    _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    tc = compile_problem(tp, tu, solver=solver, schur_family=pt.Euclidean(3))
    ops_t = tc.ctx(pt.Options(linear_tol=1e-12)).linops
    _, sys_t = tc.assemble(tp.stacked_variables())
    g_j, g_t = ops_j.grad(sys_j), ops_t.grad(sys_t)
    _close(g_t, g_j)
    v = np.random.default_rng(1).standard_normal(g_t.shape[0])
    for x_t, x_j in ((g_t, g_j), (torch.from_numpy(v), jnp.asarray(v))):
        _close(ops_t.quad(sys_t, x_t), jax.jit(ops_j.quad)(sys_j, x_j))
    if solver == "schur_cg":
        return
    x_j, ghg_j = jax.jit(ops_j.solve0_quad_grad)(sys_j)
    x_t, ghg_t = ops_t.solve0_quad_grad(sys_t)
    _close(x_t, x_j)
    _close(ghg_t, ghg_j)
    _close(ghg_t, ops_t.quad(sys_t, g_t))
    zero = torch.zeros((), dtype=torch.float64)
    for lu in (False, True):
        x, ghg, ok = ops_t.leg_ex(sys_t, zero, lu)
        _close(x, x_j)
        assert torch.equal(ghg, ghg_t) and (lu or bool(ok))
    # Newton's damped trial at λ = 0 solves the same system.
    _close(ops_t.solve(sys_t, 0.0), x_j)


@pytest.mark.parametrize("iterator", ITERATORS)
def test_iterators_match_jax_gauge_fixed(iterator):
    """Each iterator on the gauge-fixed flagship through the direct Schur
    path, through both assembly routes (``w_impl="fused_all"``, and the
    dual-sorted ``"fused"`` through the stepped driver): the JAX package's
    trace and its iteration, solve and cost-evaluation counts."""
    (jp, ju), _ = _pair()
    r_j = nt.optimize(jp, _opts(nt, iterator=iterator, store_trajectory="jit"), unfixed=ju)
    ref = np.asarray(r_j.trajectory.costs)
    for w_impl, cb in (("fused_all", {}), ("fused", dict(callback=pt.null_callback))):
        _, (tp, tu) = _pair()
        r = pt.optimize(tp, _opts(pt, iterator=iterator), unfixed=tu, w_impl=w_impl, **cb)
        assert (r.num_iterations, r.linear_solves, r.cost_computations) == (
            r_j.num_iterations, r_j.linear_solves, r_j.cost_computations), w_impl
        np.testing.assert_allclose(r.start_cost, r_j.start_cost, rtol=1e-14)
        np.testing.assert_allclose(r.costs, ref, rtol=1e-10, err_msg=w_impl)
        np.testing.assert_allclose(r.best_cost, r_j.best_cost, rtol=1e-10)
    assert r.num_iterations >= 4


def test_dogleg_implicit_matches_jax():
    """Dogleg through the implicit path (``solver="schur_cg"``: the
    Newton leg by PCG at λ = 0, gᵀHg through B6's plain version) on the
    free flagship: the JAX package's trace within 1e-8, its iterations
    and solves."""
    (jp, _), (tp, _) = _pair(gauge=False)
    kw = dict(iterator=pt.DOGLEG, solver="schur_cg", linear_tol=1e-10, rel_dcost=1e-6)
    r_j = nt.optimize(jp, _opts(nt, **kw, store_trajectory="jit"))
    r = pt.optimize(tp, _opts(pt, **kw))
    assert (r.num_iterations, r.linear_solves) == (r_j.num_iterations, r_j.linear_solves)
    assert r.num_iterations >= 4
    np.testing.assert_allclose(r.costs, np.asarray(r_j.trajectory.costs), rtol=1e-8)


def test_initial_trust_radius_and_step_size():
    """``Options.init_trust_radius`` caps dogleg's first step at that
    radius (the truncated Cauchy step), and ``init_gd_step`` sets gradient
    descent's first step to −s·g; the defaults (0: the Cauchy point, 1)
    give other first steps."""
    def first_step_norm(**kw):
        _, (tp, tu) = _pair()
        r = pt.optimize(tp, _opts(pt, store_trajectory="jit", max_iters=1, **kw), unfixed=tu)
        return r.trajectory.step_norms[0]

    tr = first_step_norm(iterator=pt.DOGLEG, init_trust_radius=1e-3)
    np.testing.assert_allclose(tr, 1e-3, rtol=1e-12)
    assert abs(first_step_norm(iterator=pt.DOGLEG) - 1e-3) > 1e-4
    _, (tp, tu) = _pair()
    comp = compile_problem(tp, tu, solver="schur", schur_family=pt.Euclidean(3))
    _, sys_ = comp.assemble(tp.stacked_variables())
    gnorm = float(comp.ctx().grad(sys_).norm())
    gd = first_step_norm(iterator=pt.GRADIENT_DESCENT, init_gd_step=1e-4)
    np.testing.assert_allclose(gd, 1e-4 * gnorm, rtol=1e-12)
    assert first_step_norm(iterator=pt.GRADIENT_DESCENT) != gd


def _case(backend):
    if backend == "dense":
        p, poses, _ = make_pose_graph(12, 4, noise=0.01, device="cpu")
        return p, poses[1:], "dense"
    _, (tp, tu) = _pair(gauge=backend == "direct")
    return tp, tu, "schur_cg" if backend == "implicit" else "schur"


@pytest.mark.parametrize("backend", ["direct", "implicit", "dense"])
@pytest.mark.parametrize("iterator", ITERATORS)
def test_graph_pieces_match_run_loop(backend, iterator):
    """The graph driver's pieces (leg, combination trials, the damped
    trial at λ = 0), run eagerly, and the stepped driver give ``run_loop``'s
    trace, solves and final variables bit for bit, for each iterator on
    each backend."""
    problem, unfixed, solver = _case(backend)
    opts = _opts(pt, iterator=iterator, solver=solver, max_iters=6, linear_tol=1e-8)
    comp = compile_problem(problem, unfixed, solver=solver, schur_family=opts.schur_family)
    vars0 = problem.stacked_variables()
    ref = run_loop(comp.assemble, comp.cost, comp.ctx(opts), opts, vars0)
    for got in (run_graphs(comp, opts, vars0), run_stepped(comp, opts, vars0)):
        assert got["iternum"] == ref["iternum"] >= 2
        assert (got["nsolve"], got["ncost"]) == (ref["nsolve"], ref["ncost"])
        assert [c.tobytes() for c in got["trace"]] == [c.tobytes() for c in ref["trace"]]
        for k, v in ref["variables"].items():
            assert torch.equal(got["variables"][k], v), k
    assert ref["nsolve"] == (0 if iterator == pt.GRADIENT_DESCENT else ref["iternum"])


def test_graph_runner_captures_only_its_iterators_pieces():
    """The graph driver builds the pieces its iterator runs and no other."""
    from nllstpu_torch.core.optimize import _GraphRunner

    _, (tp, tu) = _pair()
    comp = compile_problem(tp, tu, solver="schur", schur_family=pt.Euclidean(3))
    vars0 = tp.stacked_variables()
    pieces = {it: set(_GraphRunner(comp, _opts(pt, iterator=it), vars0).bodies)
              for it in (pt.LEVENBERG_MARQUARDT, *ITERATORS)}
    assert pieces[pt.NEWTON] == pieces[pt.LEVENBERG_MARQUARDT] == {"assemble", "trial",
                                                                   "trial_lu"}
    assert pieces[pt.DOGLEG] == {"assemble", "leg", "leg_lu", "trial_cauchy", "trial_newton",
                                 "trial_blend"}
    assert pieces[pt.GRADIENT_DESCENT] == {"assemble", "trial_gradient"}
    (_, _), (tp, _) = _pair(gauge=False)
    comp = compile_problem(tp, solver="schur_cg", schur_family=pt.Euclidean(3))
    runner = _GraphRunner(comp, dataclasses.replace(_opts(pt), iterator=pt.DOGLEG),
                          tp.stacked_variables())
    assert set(runner.bodies) == {"assemble", "pcg_setup", "pcg_chunk", "pcg_leg",
                                  "trial_cauchy", "trial_newton", "trial_blend"}
