"""The port's two drivers on the CPU in float64: the graph driver's body
(what the card captures in CUDA graphs, run eagerly here) against
``run_loop`` bit for bit, the stepped driver's callbacks, cost trajectories
and phase times against the JAX package's stepped driver, λ as a 0-d
tensor through every solve, and the capture-safe Cholesky."""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.models.ba import make_pinhole_ba as jax_make_ba
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
import nllstpu_torch as pt
from nllstpu_torch.core import linearsolver
from nllstpu_torch.core.optimize import compile_problem, run_graphs, run_loop, run_stepped
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
from nllstpu_torch.ops import schur, schur_reduce

#: The flagship shape (8 cameras, 64 landmarks, all visible) and a tiny
#: skewed BAL problem for the implicit backend.
FLAGSHIP = dict(ncameras=8, nlandmarks=64, prop_visible=1.0, noise=1e-3)
TINY_BAL = dict(ncameras=8, npoints=150, seed=3, noise=1e-3, track_alpha=2.3)
LMK = pt.family_name(pt.Euclidean(3))


def _pinhole(dtype=torch.float64):
    p, _, lmks = make_pinhole_ba(**FLAGSHIP, dtype=dtype, batched="cm", device="cpu")
    perturb_ba(p, lmks, 0.01, seed=5)
    return p


def _jax_pinhole():
    p, _, lmks = jax_make_ba(**FLAGSHIP, dtype=jnp.float64, batched="cm")
    jax_perturb_ba(p, lmks, 0.01, seed=5)
    return p


def _tiny_bal():
    p, _, pts = tbal.make_bal_problem(tbal.make_realistic_bal(**TINY_BAL),
                                      dtype=torch.float64, device="cpu")
    perturb_ba(p, pts, 0.05, seed=5)
    return p


def _opts(**kw):
    # No wall-clock stop: on a loaded host a run could pass the default
    # 30 s and end on time, not on the iterations the drivers must share.
    return pt.Options(**{"solver": "schur", "schur_family": pt.Euclidean(3),
                         "max_time": float("inf"), **kw})


@pytest.mark.parametrize("case", ["pinhole f64", "pinhole f32", "implicit f64"])
def test_graph_body_matches_run_loop(case):
    """The graph driver's pieces, run eagerly, and the stepped driver give
    ``run_loop``'s trace, damped solves and final variables bit for bit
    (the implicit path also its PCG iterations per solve)."""
    if case == "implicit f64":
        problem, opts = _tiny_bal(), _opts(solver="schur_cg", linear_tol=1e-2,
                                                       max_iters=8)
    else:
        problem = _pinhole(torch.float32 if "f32" in case else torch.float64)
        opts = _opts()
    comp = compile_problem(problem, solver=opts.solver, schur_family=opts.schur_family)
    vars0 = problem.stacked_variables()
    ctx = comp.ctx(opts)
    ref = run_loop(comp.assemble, comp.cost, ctx, opts, vars0)
    runs = [run_graphs(comp, opts, vars0), run_stepped(comp, opts, vars0)]
    for got in runs:
        assert got["iternum"] == ref["iternum"] >= 2
        assert got["nsolve"] == ref["nsolve"] and got["converged"] == ref["converged"]
        assert [c.tobytes() for c in got["trace"]] == [c.tobytes() for c in ref["trace"]]
        for k, v in ref["variables"].items():
            assert torch.equal(got["variables"][k], v), k
    # Nothing captured on the CPU; the pieces' eager runs are counted.
    assert runs[0]["capture_seconds"] == 0.0
    assert runs[0]["replays"]["assemble"] == ref["iternum"]
    assert set(runs[1]["seconds"]) == {"assemble", "solve", "cost"}
    if comp.schur_info.implicit:
        assert len(ctx.linops.cg_iters) == ref["nsolve"]


def test_drivers_match_the_jax_stepped_driver():
    """The JAX package's stepped driver (``store_trajectory=True``) against
    the port's graph driver, its stepped driver with
    ``store_trajectory=True`` and with ``store_costs_callback``: the same
    iterations and damped solves, costs within 1e-9 relative and step
    vectors within 1e-6; ``null_callback`` gives the graph driver's best
    cost and iteration count; the stepped driver's phase times are
    finite, the graph driver's NaN."""
    r_j = nt.optimize(_jax_pinhole(), nt.Options(
        solver="schur", schur_family=nt.Euclidean(3), store_trajectory=True))
    j_costs = np.asarray(r_j.trajectory.costs)
    r_graph = pt.optimize(_pinhole(), _opts())
    r_traj = pt.optimize(_pinhole(), _opts(store_trajectory=True))
    store = pt.CostTrajectory()
    r_cb = pt.optimize(_pinhole(), _opts(), callback=pt.store_costs_callback(store))
    r_null = pt.optimize(_pinhole(), _opts(), callback=pt.null_callback)
    for r, costs in ((r_graph, r_graph.costs), (r_traj, r_traj.trajectory.costs),
                     (r_cb, store.costs)):
        assert r.num_iterations == r_j.num_iterations == len(costs)
        assert r.linear_solves == r_j.linear_solves
        np.testing.assert_allclose(costs, j_costs, rtol=1e-9)
        np.testing.assert_allclose(r.start_cost, r_j.start_cost, rtol=1e-12)
    for steps in (r_traj.trajectory.trajectory, store.trajectory):
        assert len(steps) == len(r_j.trajectory.trajectory)
        for a, b in zip(steps, r_j.trajectory.trajectory):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-10)
    assert len(r_traj.trajectory.times_ns) == r_traj.num_iterations
    assert np.all(np.diff(r_traj.trajectory.times_ns) >= 0)
    assert r_null.best_cost == r_graph.best_cost
    assert r_null.num_iterations == r_graph.num_iterations
    for r in (r_traj, r_cb, r_null):
        times = (r.time_cost, r.time_gradient, r.time_solver)
        assert all(math.isfinite(t) and t > 0 for t in times), times
    assert all(math.isnan(t) for t in (r_graph.time_cost, r_graph.time_gradient,
                                        r_graph.time_solver))
    assert r_graph.trajectory is None


def test_callback_flags_and_max_time():
    """A callback's flags end the run after one iteration, shifted into
    the termination bits beside ``max_time``'s (the JAX package's
    ``test_callback_and_maxtime_termination``)."""
    problem = _pinhole()
    seen = []

    def cb(cost, ctx):
        seen.append((ctx.iteration, ctx.problem is problem, ctx.step.shape))
        return cost, 13

    r = pt.optimize(problem, _opts(max_time=0.0), callback=cb)
    assert r.termination == (1 << 9) | (13 << 16)
    assert r.num_iterations == 1 and len(seen) == 1 and seen[0][:2] == (1, True)
    assert "Terminated by user-defined callback, with flags: 1101" in r.termination_reasons()


def test_callback_replacing_a_landmark_matches_jax():
    """A callback that moves landmark 0 at the second iteration and returns
    ``ctx.cost_fn``'s cost of the changed variables: both packages adopt
    the change and give the same trace (1e-9 relative), which departs from
    the trace without it."""

    def jax_cb(cost, ctx):
        if ctx.iteration != 2:
            return cost, 0
        ctx.variables[LMK] = ctx.variables[LMK].at[0].add(0.05)
        return float(ctx.cost_fn(ctx.variables)), 0

    def port_cb(cost, ctx):
        if ctx.iteration != 2:
            return cost, 0
        v = ctx.variables[LMK].clone()
        v[0] += 0.05
        ctx.variables[LMK] = v
        return ctx.cost_fn(ctx.variables), 0

    jp = _jax_pinhole()
    r_j = nt.optimize(jp, nt.Options(
        solver="schur", schur_family=nt.Euclidean(3), store_trajectory=True), callback=jax_cb)
    problem = _pinhole()
    r_t = pt.optimize(problem, _opts(store_trajectory=True), callback=port_cb)
    r_plain = pt.optimize(_pinhole(), _opts())
    assert r_t.num_iterations == r_j.num_iterations
    assert r_t.linear_solves == r_j.linear_solves
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
    assert abs(r_t.costs[1] - r_plain.costs[1]) > 1e-3 * r_plain.costs[1]
    np.testing.assert_allclose(problem.stacked_variables()[LMK].numpy(),
                               np.asarray(jp.stacked_variables()[LMK]), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("case", ["direct", "implicit"])
def test_lambda_tensor_gives_the_float_bits(case):
    """λ as a 0-d float64 tensor gives the float's bits through every
    solve: the direct solve's three routes (kernel B3's plain version on a
    float32 system, B4's on the float64 one, B5's with pairs given), its
    capture-safe form, B3's plain version alone and the damped inverse;
    the implicit PCG solve."""
    if case == "implicit":
        problem = _tiny_bal()
        comp = compile_problem(problem, solver="schur_cg", schur_family=pt.Euclidean(3))
        ops = comp.ctx(_opts(linear_tol=1e-2)).linops
        _, sys_ = comp.assemble(problem.stacked_variables())
        for lam in (1e-3, 0.5):
            assert torch.equal(ops.solve(sys_, lam),
                               ops.solve(sys_, torch.tensor(lam, dtype=torch.float64)))
        assert len(ops.cg_iters) == 4 and ops.cg_iters[0] == ops.cg_iters[1]
        return
    problem = _pinhole()
    comp = compile_problem(problem, solver="schur", schur_family=pt.Euclidean(3))
    ops = comp.ctx().linops
    _, sys64 = comp.assemble(problem.stacked_variables())
    sys32 = tuple(t.float() for t in sys64)
    routes = [(ops, sys64, 1e-3), (ops, sys32, float(np.float32(1e-3))),
              (dataclasses.replace(ops, pairs=ops.rows), sys64, 2.5e-2)]
    for o, s, lam in routes:
        lam_t = torch.tensor(lam, dtype=torch.float64)
        x = o.solve(s, lam)
        assert torch.equal(x, o.solve(s, lam_t))
        x_ex, ok = o.solve_ex(s, lam_t)
        assert bool(ok) and torch.equal(x_ex, x)
    w, h_ll, g_l = sys32[4], sys32[2], sys32[3]
    lam = float(np.float32(3e-2))
    lam_t = torch.tensor(lam, dtype=torch.float64)
    for a, b in zip(schur_reduce.reduce_s_damped_reference(w, h_ll, g_l, lam),
                    schur_reduce.reduce_s_damped_reference(w, h_ll, g_l, lam_t)):
        assert torch.equal(a, b)
    assert torch.equal(schur.SchurOps.damped_inverse(h_ll, lam),
                       schur.SchurOps.damped_inverse(h_ll, lam_t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_solve_ex_flags_failures(monkeypatch, dtype):
    """``cholesky_solve_ex`` answers an SPD system with ``cholesky_solve``'s
    bits and ok; it sets ok false on an indefinite matrix and on a factor
    with a non-finite entry that ``info`` reports as a success, and there
    ``lu_solve`` gives ``cholesky_solve``'s bits."""
    rng = np.random.default_rng(7)
    m = rng.standard_normal((6, 6))
    spd = torch.from_numpy(m @ m.T + np.eye(6)).to(dtype)
    indefinite = torch.from_numpy(np.diag([1.0, -2.0, 3.0, 4.0, -5.0, 6.0]) + 0.1).to(dtype)
    b = torch.from_numpy(rng.standard_normal(6)).to(dtype)
    x, ok = linearsolver.cholesky_solve_ex(spd, b)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert torch.equal(x, linearsolver.cholesky_solve(spd, b))
    x, ok = linearsolver.cholesky_solve_ex(indefinite, b)
    assert not bool(ok)
    assert torch.equal(linearsolver.lu_solve(indefinite, b),
                       linearsolver.cholesky_solve(indefinite, b))
    real = torch.linalg.cholesky_ex

    def poisoned(a):
        chol, info = real(a)
        chol = chol.clone()
        chol[3, 3] = float("nan")
        return chol, torch.zeros_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", poisoned)
    _, ok = linearsolver.cholesky_solve_ex(spd, b)
    assert not bool(ok)
    assert torch.equal(linearsolver.lu_solve(spd, b), linearsolver.cholesky_solve(spd, b))


def test_graph_driver_trajectory_and_options():
    """``store_trajectory="jit"`` keeps the graph driver and records its
    costs and step norms (the stepped driver's step vectors' norms);
    ``"jit_full"`` records the stepped driver's step vectors too."""
    r = pt.optimize(_pinhole(), _opts(store_trajectory="jit"))
    r_s = pt.optimize(_pinhole(), _opts(store_trajectory=True))
    tr = r.trajectory
    assert tr.costs == r.costs == r_s.trajectory.costs
    assert tr.times_ns == [] and tr.trajectory == []
    np.testing.assert_allclose(tr.step_norms,
                               [np.linalg.norm(s) for s in r_s.trajectory.trajectory],
                               rtol=1e-12)
    assert math.isnan(r.time_solver)
    full = pt.optimize(_pinhole(), _opts(store_trajectory="jit_full")).trajectory
    assert full.costs == tr.costs and full.step_norms == tr.step_norms
    for a, b in zip(full.trajectory, r_s.trajectory.trajectory, strict=True):
        np.testing.assert_array_equal(a, b)
