"""The port's matrix-free "cg" backend against the JAX package's, on the
CPU in float64: the system of an affine BA problem (cost, gradient,
diagonal, xᵀHx and the PCG solve at three λ, beside the port's own dense
solve), the pose graph's LM and dogleg traces through both drivers, the
fixed summation order, and the cases of the JAX package's ``test_cg.py``
(``solver="auto"``, the float32 pose graph, ``linear_tol``).

Tolerances: the system within 1e-12 relative (the same float64 products,
summed in another order); a solve within 1e-9 of its largest entry (PCG to
a relative residual of 1e-14 in both packages, iterating in another
rounding); the port's cg solve against its dense solve at the JAX test's
rtol 1e-5 / atol 1e-8; the pose graph's traces with the JAX run's
iteration count and every cost within 1e-9 relative; the stepped driver
gives the graph driver's trace bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models.ba import make_affine_ba as jax_affine_ba
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.models.posegraph import make_pose_graph as jax_pose_graph
import nllstpu_torch as pt
from nllstpu_torch.core.optimize import compile_problem
from nllstpu_torch.models.ba import make_affine_ba, perturb_ba
from nllstpu_torch.models.posegraph import make_pose_graph
from nllstpu_torch.models.rosenbrock import make_rosenbrock
from nllstpu_torch.ops.cg import CG_MAX_ITERS


def _affine(make, perturb):
    p, cams, lmks = make(4, 9, 1.0)
    perturb(p, lmks, 0.05, seed=3)
    perturb(p, cams, 0.05, seed=4)
    return p, cams + lmks[3:]  # the gauge pinned


@pytest.fixture(scope="module")
def affine():
    """Both packages' cg systems of ``make_affine_ba(4, 9)`` (seeds 3 and
    4, three landmarks fixed), and the JAX solves at λ ∈ {0, 1e-3, 1}."""
    jp, ju = _affine(jax_affine_ba, jax_perturb_ba)
    jc = jax_compile(jp, unfixed=ju, solver="cg")
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    tp, tu = _affine(lambda *a: make_affine_ba(*a, device="cpu"), perturb_ba)
    for name, v in jp.stacked_variables().items():
        assert np.array_equal(np.asarray(v), tp.stacked_variables()[name].numpy()), name
    tc = compile_problem(tp, tu, solver="cg")
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    dense = compile_problem(tp, tu, solver="dense")
    _, sys_d = dense.assemble(tp.stacked_variables())
    solves = {lam: np.asarray(jc.cg_ops.solve(sys_j, jnp.asarray(lam))) for lam in (0.0, 1e-3, 1.0)}
    return dict(jops=jc.cg_ops, sys_j=sys_j, cost_j=cost_j, ops=tc.ctx().linops, sys_t=sys_t,
                cost_t=cost_t, dops=dense.ctx().linops, sys_d=sys_d, solves=solves)


def test_cg_system_matches_jax(affine):
    """Cost, gradient, largest diagonal entry and xᵀHx within 1e-12."""
    a = affine
    ops, jops, st, sj = a["ops"], a["jops"], a["sys_t"], a["sys_j"]
    np.testing.assert_allclose(float(a["cost_t"]), float(a["cost_j"]), rtol=1e-12)
    np.testing.assert_allclose(ops.grad(st).numpy(), np.asarray(jops.grad(sj)), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jops.grad(sj))).max())
    np.testing.assert_allclose(float(ops.diag_max(st)), float(jops.diag_max(sj)), rtol=1e-12)
    x = np.random.default_rng(0).standard_normal(ops.dim)
    np.testing.assert_allclose(float(ops.quad(st, torch.tensor(x))),
                               float(jops.quad(sj, jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("lam", [0.0, 1e-3, 1.0])
def test_cg_solve_matches_jax_and_dense(affine, lam):
    """The PCG solve at λ: the JAX package's within 1e-9 of its largest
    entry, and the port's dense solve at rtol 1e-5 / atol 1e-8."""
    a = affine
    lam_t = torch.tensor(lam, dtype=torch.float64)
    x = a["ops"].solve(a["sys_t"], lam_t).numpy()
    ref = a["solves"][lam]
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-9 * np.abs(ref).max())
    np.testing.assert_allclose(x, a["dops"].solve(a["sys_d"], lam_t).numpy(), rtol=1e-5,
                               atol=1e-8)
    assert 0 < a["ops"].cg_iters[-1] < CG_MAX_ITERS


def _pose_opts(pkg, iterator, **kw):
    return pkg.Options(iterator=iterator, solver="cg", rel_dcost=1e-12, **kw)


@pytest.mark.parametrize("iterator", [pt.LEVENBERG_MARQUARDT, pt.DOGLEG])
def test_pose_graph_traces_match_jax(iterator):
    """The 20-pose SE(3) graph, pose 0 fixed, through ``solver="cg"``:
    the JAX package's iteration count and every cost within 1e-9
    relative; the stepped driver gives the graph driver's trace bit for
    bit, and each PCG solve converged below the cap."""
    jp, jposes, _ = jax_pose_graph(20, 5, noise=0.01)
    r_j = nt.optimize(jp, _pose_opts(nt, iterator, store_trajectory="jit"), unfixed=jposes[1:])
    p, poses, _ = make_pose_graph(20, 5, noise=0.01, device="cpu")
    comp = compile_problem(p, poses[1:], solver="cg")
    final = pt.run_graphs(comp, _pose_opts(pt, iterator), p.stacked_variables())
    assert final["iternum"] == r_j.num_iterations
    np.testing.assert_allclose(final["startcost"], r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(final["trace"], np.asarray(r_j.trajectory.costs), rtol=1e-9)
    assert final["cg_iters"] and all(0 < k < CG_MAX_ITERS for k in final["cg_iters"])
    p2, poses2, _ = make_pose_graph(20, 5, noise=0.01, device="cpu")
    r_s = pt.optimize(p2, _pose_opts(pt, iterator), unfixed=poses2[1:],
                      callback=pt.null_callback)
    assert r_s.costs == [float(c) for c in final["trace"]]


def test_cg_sums_repeat_their_bits():
    """Two assemblies give the same bits in every part of the system, and
    two matvecs the same vector: every per-variable sum runs in the
    compile-time order (through B6's plain version here)."""
    p, poses, _ = make_pose_graph(30, 10, noise=0.01, device="cpu")
    comp = compile_problem(p, poses[1:], solver="cg")
    ops = comp.ctx().linops
    variables = p.stacked_variables()
    (c1, s1), (c2, s2) = comp.assemble(variables), comp.assemble(variables)
    assert torch.equal(c1, c2)
    for a, b in zip((s1[0], *s1[1], *s1[3], s1[4]), (s2[0], *s2[1], *s2[3], s2[4])):
        assert torch.equal(a, b)
    x = torch.randn(ops.dim, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    lam = torch.tensor(1e-3, dtype=torch.float64)
    assert torch.equal(ops.matvec(s1, lam, x), ops.matvec(s2, lam, x))
    # The matvec is H·x + λx of the dense backend's H.
    _, (h, _) = compile_problem(p, poses[1:], solver="dense").assemble(variables)
    np.testing.assert_allclose(ops.matvec(s1, lam, x).numpy(), (h @ x + 1e-3 * x).numpy(),
                               rtol=0, atol=1e-12 * float((h @ x).abs().max()))


def test_auto_solver_selection():
    """``solver="auto"`` picks as the JAX package's ``test_cg.py`` says:
    dense on Rosenbrock (d ≤ 40), cg on an 18-pose chain (d = 102,
    nearest-neighbour coupling), dense on the fully coupled affine BA at
    6/10."""
    p, _, _ = make_rosenbrock(device="cpu")
    c = compile_problem(p, solver="auto")
    assert c.cg_ops is None and c.schur_info is None and c.dense_plan is not None
    p, poses, _ = make_pose_graph(n_poses=18, n_loops=0, perturb=0.01, device="cpu")
    assert compile_problem(p, poses[1:], solver="auto").cg_ops is not None
    p, _, _ = make_affine_ba(6, 10, 1.0, device="cpu")
    c = compile_problem(p, solver="auto")
    assert c.cg_ops is None and c.schur_info is None


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_converges(solver):
    """The 16-pose graph from a 0.05 perturbation, pose 0 fixed, LM:
    below 1e-18 and on the truth within 1e-8 (the JAX test's bounds)."""
    p, poses, truth = make_pose_graph(n_poses=16, n_loops=4, perturb=0.05, device="cpu")
    assert pt.cost(p) > 1e-4
    r = pt.optimize(p, pt.Options(solver=solver), unfixed=poses[1:])
    assert r.best_cost < 1e-18
    np.testing.assert_allclose(np.stack([p.get_value(h) for h in poses]), truth, atol=1e-8)


def test_dogleg_on_cg_backend():
    p, poses, _ = make_pose_graph(n_poses=12, n_loops=3, perturb=0.05, device="cpu")
    r = pt.optimize(p, pt.Options(solver="cg", iterator=pt.DOGLEG), unfixed=poses[1:])
    assert r.best_cost < 1e-10


def test_pose_graph_f32_converges():
    """A float32 64-pose graph with every pose free (the gauge left open)
    below 1e-6 in 30 iterations."""
    p, _, _ = make_pose_graph(n_poses=64, n_loops=8, perturb=0.05, dtype=torch.float32,
                              device="cpu")
    r = pt.optimize(p, pt.Options(solver="cg", max_iters=30))
    assert r.best_cost < 1e-6, r.best_cost


def test_linear_tol_option():
    """``linear_tol=1e-2`` loosens the PCG: LM still reaches 1e-18 on the
    32-pose graph, in fewer PCG iterations per solve than the default."""
    runs = {}
    for tol in (None, 1e-2):
        p, _, _ = make_pose_graph(n_poses=32, n_loops=6, perturb=0.05, device="cpu")
        comp = compile_problem(p, solver="cg")
        opts = pt.Options(solver="cg", linear_tol=tol, max_iters=40)
        runs[tol] = pt.run_stepped(comp, opts, p.stacked_variables())
    assert runs[1e-2]["bestcost"] < 1e-18
    mean = {t: np.mean(r["cg_iters"]) for t, r in runs.items()}
    assert mean[1e-2] < mean[None], mean
