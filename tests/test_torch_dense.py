"""The port's dense backend against the JAX package, on the CPU in float64:
generic cost batches (single costs, a plain ``kind="cost"`` cost, a
row-major batch with a hand Jacobian, a per-cost batch and a
components-major batch with autodiff Jacobians, each robustified), the
fixed robust kernels, ``SO3`` and ``so3_log``, the small models
(Rosenbrock through all four iterators, robust curve fitting under each
fixed kernel, a 20-pose pose graph), ``make_pinhole_ba``'s per-cost
and row-major forms, and ``solver="auto"`` (and the refusal that
remains: an adaptive kernel on the dense backend).

Tolerances: the assembled system (cost, H, g) within 1e-12 of its largest
entry (the same float64 arithmetic, summed in another order); kernels
and manifolds within 1e-14; traces within 1e-10 relative per iteration,
with the same iteration, solve and cost-evaluation counts (Rosenbrock,
whose cost reaches 0, within 1e-10 of its start cost, and gradient
descent, whose whole run sits within 1e-12 of the optimum where the
residual 1 − x loses ten digits, on the functional test's convergence
instead).  The runs stop before the float64 rounding floor
(``rel_dcost``), where a 1e-16 cost change is accepted or rejected by
rounding alone."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core import engine as jax_engine
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.core.manifolds import so3_exp as jax_so3_exp
from nllstpu.core.manifolds import so3_log as jax_so3_log
from nllstpu.models import ba as jba
from nllstpu.models import bal as jbal
from nllstpu.models.curvefit import make_curve_fit as jax_curve_fit
from nllstpu.models.posegraph import make_pose_graph as jax_pose_graph
from nllstpu.models.rosenbrock import make_rosenbrock as jax_rosenbrock
import nllstpu_torch as pt
from nllstpu_torch.core.optimize import compile_problem
from nllstpu_torch.models import ba as tba
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.curvefit import make_curve_fit
from nllstpu_torch.models.posegraph import make_pose_graph
from nllstpu_torch.models.rosenbrock import make_rosenbrock

KERNELS = ("GemanMcclure", "Cauchy", "Welsch", "Tukey")


# -- one generic problem, built in both packages from the same arrays ------


def _rot_res_jax(p, r, x):
    return jnp.concatenate([jax_so3_log(p.T @ r), x - 0.5])


def _rot_res_torch(p, r, x):
    return torch.cat([pt.so3_log(p.T @ r), x - 0.5])


def _rowmajor_jax(p, x, s):
    return x * s[:, None] - p


def _rowmajor_jac_jax(p, x, s):
    b = x.shape[0]
    jac = jnp.zeros((b, 2, 3), x.dtype)
    jac = jac.at[:, 0, 0].set(s).at[:, 1, 1].set(s)
    jac = jac.at[:, 0, 2].set(x[:, 0]).at[:, 1, 2].set(x[:, 1])
    return x * s[:, None] - p, jac


def _rowmajor_torch(p, x, s):
    return x * s[:, None] - p


def _rowmajor_jac_torch(p, x, s):
    jac = x.new_zeros(x.shape[0], 2, 3)
    jac[:, 0, 0] = jac[:, 1, 1] = s
    jac[:, 0, 2], jac[:, 1, 2] = x[:, 0], x[:, 1]
    return x * s[:, None] - p, jac


def _single_jax(p, x, s):
    return jnp.stack([x[0] * s - p[0], x[1] + s * s - p[1]])


def _single_torch(p, x, s):
    return torch.stack([x[0] * s - p[0], x[1] + s * s - p[1]])


def _plain_jax(p, x, s):
    return p * (x[0] ** 2 * x[1] ** 2) + jnp.sin(x[0] * s)


def _plain_torch(p, x, s):
    return p * (x[0] ** 2 * x[1] ** 2) + torch.sin(x[0] * s)


def _generic_arrays(seed=0):
    rng = np.random.default_rng(seed)
    jp, _, _ = jba.make_pinhole_ba(3, 10, 1.0, noise=1e-2, dtype=jnp.float64, batched="cm")
    (cm,) = jp.batches()
    mask = np.asarray(cm.mask)
    rots = np.stack([np.asarray(jax_so3_exp(jnp.asarray(w))) for w in rng.normal(0, 0.3, (2, 3))])
    return dict(
        cams=np.asarray(jp.stacked_variables()["SE3()"]),
        pts=np.asarray(jp.stacked_variables()["Euclidean(n=3)"]) + rng.normal(0, 0.05, (10, 3)),
        cm_idx=[np.asarray(i)[mask] for i in cm.idx], cm_meas=np.asarray(cm.params)[mask],
        e2=rng.normal(size=(4, 2)), sc=rng.normal(1.0, 0.3, 3), rots=rots,
        rot_meas=np.stack([np.asarray(jax_so3_exp(jnp.asarray(w)))
                           for w in rng.normal(0, 0.3, (5, 3))]),
        rot_idx=(rng.integers(0, 2, 5), rng.integers(0, 4, 5)),
        row_idx=(rng.integers(0, 4, 6), rng.integers(0, 3, 6)), row_p=rng.normal(size=(6, 2)),
        single=[((0, 1), rng.normal(size=2)), ((2, 2), rng.normal(size=2)),
                ((3, 0), rng.normal(size=2))],
        plain=[((1, 1), 0.7), ((3, 2), 1.3)],
    )


def _generic(pkg, a):
    """The generic problem in ``pkg`` (``nt`` or ``pt``): returns the
    problem and its ``unfixed`` handles (camera 0 and scalar 0 fixed)."""
    torch_side = pkg is pt
    p = pt.Problem(device="cpu") if torch_side else nt.Problem(dtype=jnp.float64)
    cams = p.add_variables(pkg.SE3(), a["cams"])
    pts = p.add_variables(pkg.Euclidean(3), a["pts"])
    e2 = p.add_variables(pkg.Euclidean(2), a["e2"])
    sc = p.add_variables(pkg.Scalar(), a["sc"])
    rots = p.add_variables(pkg.SO3(), a["rots"])
    model = tba if torch_side else jba
    p.add_cost_batch(model.pinhole_project_cm,
                     slots=[(pkg.SE3(), a["cm_idx"][0]), (pkg.Euclidean(3), a["cm_idx"][1])],
                     params=a["cm_meas"], kernel=pkg.Huber(0.02), batched="cm")
    p.add_cost_batch(_rot_res_torch if torch_side else _rot_res_jax,
                     slots=[(pkg.SO3(), a["rot_idx"][0]), (pkg.Euclidean(2), a["rot_idx"][1])],
                     params=a["rot_meas"], kernel=pkg.Welsch(0.4), batched=False)
    p.add_cost_batch(_rowmajor_torch if torch_side else _rowmajor_jax,
                     slots=[(pkg.Euclidean(2), a["row_idx"][0]), (pkg.Scalar(), a["row_idx"][1])],
                     params=a["row_p"], kernel=pkg.Cauchy(0.8),
                     jacobian=_rowmajor_jac_torch if torch_side else _rowmajor_jac_jax,
                     batched=True)
    for k, ((i, j), prm) in enumerate(a["single"]):
        kernel = pkg.GemanMcclure(0.9) if k < 2 else pkg.Tukey(1.2)
        p.add_cost(_single_torch if torch_side else _single_jax, (e2[i], sc[j]), params=prm,
                   kernel=kernel)
    for (i, j), prm in a["plain"]:
        p.add_cost(_plain_torch if torch_side else _plain_jax, (e2[i], sc[j]), params=prm,
                   kind="cost")
    return p, cams[1:] + pts + e2 + sc[1:] + rots


def test_assemble_dense_matches_jax():
    """Cost, H and g of the generic problem against
    ``nllstpu.core.engine.assemble_dense``, fixed variables in the
    dustbin; and its total cost."""
    a = _generic_arrays()
    jp, ju = _generic(nt, a)
    tp, tu = _generic(pt, a)
    jc = jax_compile(jp, ju, solver="dense")
    c_j, h_j, g_j = jax.jit(
        lambda v: jax_engine.assemble_dense(jc.batches, v, jc.layout, jnp.float64)
    )(jp.stacked_variables())
    tc = compile_problem(tp, tu, solver="dense")
    assert tc.layout.dof_total == jc.layout.dof_total == 6 * 2 + 30 + 8 + 2 + 6
    c_t, (h_t, g_t) = tc.assemble(tp.stacked_variables())
    for got, ref in ((c_t, c_j), (h_t, h_j), (g_t, g_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert np.abs(np.asarray(h_j)).max() > 0
    np.testing.assert_allclose(pt.cost(tp), float(nt.cost(jp)), rtol=1e-13)


@pytest.mark.parametrize("name", KERNELS)
def test_fixed_kernels_match_jax(name):
    """ρ and (ρ, ρ′, ρ″) of each fixed kernel on both sides of its width
    (Tukey's derivatives through ``auto_rho_dc``)."""
    s = np.array([0.0, 0.03, 0.49, 0.64, 0.7, 2.0, 50.0])
    k_j, k_t = getattr(nt, name)(0.8), getattr(pt, name)(0.8)
    rho_dc_j = jax.vmap(k_j.rho_dc)(jnp.asarray(s))
    for got, ref in zip(k_t.rho_dc(torch.from_numpy(s)), rho_dc_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(k_t.rho(torch.from_numpy(s)).numpy(),
                               np.asarray(jax.vmap(k_j.rho)(jnp.asarray(s))), rtol=1e-14)


def test_so3_matches_jax():
    """``SO3.retract`` and ``so3_log`` near 0, mid-range and near π
    against the JAX functions."""
    rng = np.random.default_rng(4)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ws = axes * np.array([1e-9, 1e-4, 0.7, 2.0, np.pi - 1e-3, np.pi - 1e-6])[:, None]
    rs = np.stack([np.asarray(jax_so3_exp(jnp.asarray(w))) for w in ws])
    got = pt.so3_log(torch.from_numpy(rs)).numpy()
    ref = np.stack([np.asarray(jax_so3_log(jnp.asarray(r))) for r in rs])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[:5], ws[:5], rtol=1e-6, atol=1e-12)  # inverse of exp
    d = rng.normal(0, 0.5, (6, 3))
    ret = pt.SO3().retract(torch.from_numpy(rs), torch.from_numpy(d)).numpy()
    ref = np.stack([np.asarray(nt.SO3().retract(jnp.asarray(r), jnp.asarray(x)))
                    for r, x in zip(rs, d)])
    np.testing.assert_allclose(ret, ref, rtol=1e-14, atol=1e-15)


def _close_traces(r, r_j, rtol=1e-10, atol=0.0):
    assert r.num_iterations == r_j.num_iterations
    assert r.linear_solves == r_j.linear_solves
    assert r.cost_computations == r_j.cost_computations
    np.testing.assert_allclose(r.start_cost, r_j.start_cost, rtol=1e-14)
    np.testing.assert_allclose(r.costs, np.asarray(r_j.trajectory.costs), rtol=rtol, atol=atol)


@pytest.mark.parametrize("iterator,x0,y0,rtol", [
    (pt.NEWTON, 0.0, 0.0, 1e-10),
    (pt.LEVENBERG_MARQUARDT, -0.5, 2.5, 1e-10),
    (pt.DOGLEG, -0.5, 2.5, 1e-10),
    (pt.GRADIENT_DESCENT, 1.0 - 1e-5, 1.0, 1e-5),
])
def test_rosenbrock_matches_jax(iterator, x0, y0, rtol):
    """Rosenbrock through each iterator (``solver="auto"``, which picks
    dense, as the JAX package does): converges to (1, 1) within the
    functional test's rtols and gives the JAX package's counts and
    trace."""
    p, x, y = make_rosenbrock(x0=x0, y0=y0, device="cpu")
    r = pt.optimize(p, pt.Options(iterator=iterator))
    np.testing.assert_allclose(pt.cost(p), r.best_cost, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose([float(p.get_value(x)), float(p.get_value(y))], 1.0, rtol=rtol)
    jp, _, _ = jax_rosenbrock(x0=x0, y0=y0)
    r_j = nt.optimize(jp, nt.Options(iterator=iterator, store_trajectory="jit"))
    if iterator == pt.GRADIENT_DESCENT:
        assert (r.num_iterations, r.cost_computations) == (r_j.num_iterations,
                                                             r_j.cost_computations)
        assert r.linear_solves == r_j.linear_solves == 0
        return
    _close_traces(r, r_j, rtol=0.0, atol=1e-10 * r_j.start_cost)


def test_curve_fit_matches_jax_under_every_kernel():
    """Robust exponential curve fitting (BASELINE.json's robustifier
    sweep) under each fixed kernel, LM, stopped before the rounding floor:
    the JAX package's trace and counts; Huber, Geman-McClure and Cauchy
    pull the fit towards the truth (from the zero start the redescending
    Welsch and Tukey may settle elsewhere, as the JAX package's do)."""
    opts = dict(rel_dcost=1e-9, max_time=float("inf"))
    fits = {}
    for name in ("None", "Huber", *KERNELS):
        k_t = None if name == "None" else getattr(pt, name)(0.5)
        k_j = None if name == "None" else getattr(nt, name)(0.5)
        p, mc, truth = make_curve_fit(kernel=k_t, device="cpu")
        r = pt.optimize(p, pt.Options(**opts))
        jp, _, _ = jax_curve_fit(kernel=k_j)
        r_j = nt.optimize(jp, nt.Options(**opts, store_trajectory="jit"))
        _close_traces(r, r_j)
        fits[name] = np.abs(p.get_value(mc) - truth).max()
    assert all(fits[k] < fits["None"] / 4 for k in ("Huber", "GemanMcclure", "Cauchy")), fits


@pytest.mark.parametrize("iterator", [pt.LEVENBERG_MARQUARDT, pt.DOGLEG])
def test_pose_graph_matches_jax(iterator):
    """A 20-pose SE(3) pose graph (per-cost residuals through ``so3_log``,
    Jacobians by ``jacfwd``), pose 0 fixed, ``solver="dense"``: the JAX
    package's trace and counts; the stepped driver gives the graph
    driver's trace bit for bit."""
    opts = dict(iterator=iterator, solver="dense", rel_dcost=1e-12)
    p, poses, _ = make_pose_graph(20, 5, noise=0.01, device="cpu")
    r = pt.optimize(p, pt.Options(**opts), unfixed=poses[1:])
    jp, jposes, _ = jax_pose_graph(20, 5, noise=0.01)
    r_j = nt.optimize(jp, nt.Options(**opts, store_trajectory="jit"), unfixed=jposes[1:])
    _close_traces(r, r_j)
    p2, poses2, _ = make_pose_graph(20, 5, noise=0.01, device="cpu")
    r_s = pt.optimize(p2, pt.Options(**opts), unfixed=poses2[1:], callback=pt.null_callback)
    assert r_s.costs == r.costs


def test_auto_solver_picks_as_jax():
    """``solver="auto"``: dense on Rosenbrock (d ≤ 40), Schur over the
    detected landmark family on the flagship BA problem without a
    ``schur_family``, and on a pose graph the matrix-free "cg" backend,
    as the JAX package picks; an adaptive kernel is refused by the dense
    backend."""
    p, _, _ = make_rosenbrock(device="cpu")
    jp, _, _ = jax_rosenbrock()
    jc = jax_compile(jp, solver="auto")
    assert jc.schur_info is None and jc.cg_ops is None
    tc = compile_problem(p, solver="auto")
    assert tc.schur_info is None and tc.dense_plan is not None
    bp, _, _ = tba.make_pinhole_ba(8, 64, 1.0, dtype=torch.float64, batched="cm", device="cpu")
    jbp, _, _ = jba.make_pinhole_ba(8, 64, 1.0, dtype=jnp.float64, batched="cm")
    jc = jax_compile(jbp, solver="auto")
    tc = compile_problem(bp, solver="auto")
    assert jc.schur_info is not None and tc.schur_info is not None
    assert tc.schur_info.elim_family == jc.schur_info.elim_family == "Euclidean(n=3)"
    assert tc.layout.dof_total == jc.layout.dof_total
    gp, poses, _ = make_pose_graph(20, 5, device="cpu")
    jgp, _, _ = jax_pose_graph(20, 5)
    assert jax_compile(jgp, solver="auto").cg_ops is not None
    tc = compile_problem(gp, poses[1:], solver="auto")
    assert tc.cg_ops is not None and tc.schur_info is None and tc.dense_plan is None
    cg = pt.ContaminatedGaussian()
    bp2, _, _, _ = tbal.make_bal_problem(jbal.make_synthetic_bal(4, 8), device="cpu", kernel=cg,
                                         kernel_params=cg.make_params(1.0, 10.0, 0.8))
    # An adaptive kernel compiles on the dense backend (its blocks lead
    # with the kernel's tangent): a finite, symmetric H over every variable.
    tc = compile_problem(bp2, solver="dense")
    assert tc.dense_plan is not None and tc.schur_info is None
    _, (h, g) = tc.assemble(bp2.stacked_variables())
    assert h.shape == (tc.layout.dof_total,) * 2 == (4 * 9 + 8 * 3 + 3,) * 2
    assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(g).all())
    assert torch.equal(h, h.T)


@pytest.mark.parametrize("batched,hand", [(False, False), (True, True)])
def test_pinhole_forms_match_jax_dense_assembly(batched, hand):
    """``make_pinhole_ba`` in the JAX package's per-cost (autodiff) and
    row-major (hand Jacobian) forms, built by both packages at 8/64 with
    the points perturbed: the port's dense assembly gives the JAX
    package's cost, H and g within 1e-12 of the largest entry, and the cg
    assembly the same gradient."""
    jp, _, jl = jba.make_pinhole_ba(8, 64, 0.7, noise=1e-3, dtype=jnp.float64, batched=batched,
                                    hand_jacobian=hand)
    jba.perturb_ba(jp, jl, 0.02, seed=5)
    c_j, (h_j, g_j) = jax.jit(jax_compile(jp).assemble)(jp.stacked_variables())
    p, _, lmks = tba.make_pinhole_ba(8, 64, 0.7, noise=1e-3, dtype=torch.float64,
                                     batched=batched, hand_jacobian=hand, device="cpu")
    tba.perturb_ba(p, lmks, 0.02, seed=5)
    (b,) = p.batches()
    assert b.batched is batched and (b.jacobian is not None) == hand
    variables = p.stacked_variables()
    c, (h, g) = compile_problem(p).assemble(variables)
    for got, ref in ((c, c_j), (h, h_j), (g, g_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    _, sys_c = compile_problem(p, solver="cg").assemble(variables)
    np.testing.assert_allclose(sys_c[0].numpy(), g.numpy(), rtol=0,
                               atol=1e-12 * float(g.abs().max()))
