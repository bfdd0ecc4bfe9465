"""The port's adaptive robust kernels against the JAX package, on the CPU
in float64: the kernel-parameter manifolds, ρ and its derivatives, the EM
fit, the plain versions of kernels B7 (W placement) and B5 (the reduction
over external inverses) against the Pallas kernels in interpret mode, and
an adaptive Snavely BAL problem (6 cameras, 64 points, 10% outliers, as in
tests/test_adaptive.py) through the direct Schur solve: the assembled
system, the damped solve and the Levenberg-Marquardt trace with the
recovered kernel parameters; a further reduced family beside the kernel;
two kernel variables in one batch (direct) and an adaptive batch on the
implicit backend."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core import manifolds as jman
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.ops.pallas import schur_reduce as jax_reduce
from nllstpu.ops.pallas import w_place as jax_w_place
import nllstpu_torch as pt
from nllstpu_torch.interop import problem_from_arrays
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.ops import schur_reduce, w_place

#: Each port manifold and a generator of valid stored values.
MANIFOLDS = {
    "Scalar": (pt.Scalar(), lambda r, n: r.standard_normal(n)),
    "ZeroToInf": (pt.ZeroToInf(), lambda r, n: r.uniform(0.1, 5.0, n)),
    "ZeroToOne": (pt.ZeroToOne(), lambda r, n: r.uniform(0.05, 0.95, n)),
    "ContaminatedGaussianManifold": (
        pt.ContaminatedGaussianManifold(),
        lambda r, n: np.stack([r.uniform(0.5, 3.0, n), r.uniform(0.05, 1.0, n),
                               r.uniform(0.1, 0.9, n)], axis=1),
    ),
    "BarronManifold": (
        pt.BarronManifold(),
        lambda r, n: np.stack([r.uniform(0.1, 1.9, n), r.uniform(0.2, 3.0, n)], axis=1),
    ),
}
#: Squared norms on both sides of the outlier knee of every kernel below.
S = np.concatenate([np.logspace(-4, 4, 15), [0.0, 2.5, 7.0]])


def _close(got, ref, tol, msg=""):
    """Within ``tol`` relative, or ``tol`` of the largest entry."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max(), err_msg=msg)


@pytest.mark.parametrize("name", sorted(MANIFOLDS))
def test_manifold_retract_matches_jax(name):
    """``retract`` over a stacked family and ``retract_cm`` against the JAX
    package's vmapped ``retract`` and its ``retract_cm``, within 1e-12,
    with steps large enough to reorder the mixture's sigmas and to overflow
    the ZeroToOne update."""
    man, values = MANIFOLDS[name]
    jm = getattr(jman, name)()
    rng = np.random.default_rng(len(name))
    x = values(rng, 40)
    d = rng.standard_normal((40, man.dof)) * 2.0
    d[0] = 800.0  # exp overflows: ZeroToOne clamps to 1, ZeroToInf to inf
    ref = np.asarray(jman.batch_retract(jm, jnp.asarray(x), jnp.asarray(d)))
    got = man.retract(torch.from_numpy(x), torch.from_numpy(d)).numpy()
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    _close(got[fin], ref[fin], 1e-12, "retract")
    x_cm, d_cm = x.reshape(40, -1).T, d.T
    ref_cm = np.asarray(jm.retract_cm(jnp.asarray(x_cm), jnp.asarray(d_cm)))
    got_cm = man.retract_cm(torch.from_numpy(x_cm), torch.from_numpy(d_cm)).numpy()
    assert np.array_equal(got_cm.T.reshape(got.shape)[fin], got[fin])
    _close(got_cm[np.isfinite(ref_cm)], ref_cm[np.isfinite(ref_cm)], 1e-12, "retract_cm")


KERNELS = {
    "ContaminatedGaussian": (
        lambda m: m.ContaminatedGaussian(), lambda m: m.ContaminatedGaussian.make_params(1.0, 10.0, 0.8),
    ),
    "Barron": (lambda m: m.Barron(), lambda m: m.Barron.make_params(1.3, 0.7)),
    "Scaled(ContaminatedGaussian, 2.5)": (
        lambda m: m.Scaled(m.ContaminatedGaussian(), 2.5),
        lambda m: m.ContaminatedGaussian.make_params(0.5, 4.0, 0.6),
    ),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_derivatives_match_jax(name):
    """ρ, (ρ, ρ′, ρ″) and ρ's value, gradient and Hessian in [kernel tangent,
    s] (``rho_dkernel_cm``, on per-cost parameters) against the JAX
    package's, within 1e-12 relative (or of the largest entry, for the
    entries that vanish past the knee)."""
    make, params = KERNELS[name]
    jk, tk = make(nt), make(pt)
    assert isinstance(tk, pt.AdaptiveRobustifier) and tk.manifold == make(pt).manifold
    kp = np.asarray(params(nt), dtype=np.float64)
    assert np.array_equal(params(pt).numpy(), kp)
    s = S
    kp_cm = kp[:, None] * (1.0 + 0.01 * np.arange(len(s)))[None]
    kp_cm[-1] = kp[-1]  # a weight or a shape stays in its range
    ref_dc = jax.jit(jax.vmap(lambda v: jk.rho_dc(jnp.asarray(kp), v)))(jnp.asarray(s))
    got_dc = tk.rho_dc(torch.from_numpy(kp), torch.from_numpy(s))
    for i, (a, b) in enumerate(zip(got_dc, ref_dc)):
        _close(a.numpy(), b, 1e-12, f"rho_dc[{i}]")
    _close(tk.rho(torch.from_numpy(kp), torch.from_numpy(s)).numpy(),
           jk.rho(jnp.asarray(kp), jnp.asarray(s)), 1e-12, "rho")
    ref = jax.jit(jk.rho_dkernel_cm)(jnp.asarray(kp_cm), jnp.asarray(s))
    got = tk.rho_dkernel_cm(torch.from_numpy(kp_cm), torch.from_numpy(s))
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a.numpy(), b, 1e-12, f"rho_dkernel_cm[{i}]")


def test_em_fit_matches_jax():
    """``em_fit`` against the JAX package's on a contaminated sample: the
    same rounds, parameters within 1e-12."""
    rng = np.random.default_rng(4)
    sq = np.concatenate([rng.normal(0, 1, 800), rng.normal(0, 10, 200)]) ** 2
    kp = nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6)
    for iters in (1, 3, 10):
        ref = np.asarray(nt.em_fit(kp, jnp.asarray(sq), max_iters=iters))
        got = pt.em_fit(pt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6),
                        torch.from_numpy(sq), max_iters=iters)
        _close(got.numpy(), ref, 1e-12, f"max_iters={iters}")


def test_place_w_matches_pallas():
    """B7's plain version against ``place_w_pm`` in interpret mode, mapped
    back from its p-major columns (``p·NRp + v``) to the standard ones
    (``v·dr_s + p``): runs of K = 4 slots per landmark with a camera seen
    twice in one run and dropped slots; within 1e-12."""
    rng = np.random.default_rng(7)
    K, L, n_r, dr_s, dl = 4, 10, 5, 4, 3
    we3 = rng.standard_normal((K, dl * dr_s, L))
    vc2 = rng.integers(0, n_r, (K, L)).astype(np.int32)
    vc2[1, ::2] = vc2[0, ::2]  # the same camera twice in a run
    vc2[3, 1::3] = n_r  # dropped slots (the dustbin)
    w_pm = np.asarray(jax_w_place.place_w_pm(
        jnp.asarray(we3), jnp.asarray(vc2), n_r, dr_s, dl, interpret=True))
    nrp = w_pm.shape[1] // dr_s
    std = w_pm.reshape(dl, dr_s, nrp, L)[:, :, :n_r].transpose(3, 0, 2, 1).reshape(L, dl, n_r * dr_s)
    # The same costs in landmark order: cost l·K + k is slot k of landmark l.
    we = torch.from_numpy(we3.reshape(K, dl, dr_s, L).transpose(3, 0, 1, 2).reshape(L * K, dl, dr_s).copy())
    cam = vc2.T.reshape(-1)
    colbase = torch.from_numpy(np.where(cam < n_r, cam * dr_s, -1).astype(np.int32))
    lstarts = torch.arange(L + 1, dtype=torch.int32) * K
    got = w_place.place_w(we, lstarts, colbase, n_r * dr_s)
    _close(got.numpy(), std, 1e-12)
    # Extra columns stay zero (an adaptive kernel's), an empty run is a zero row.
    wide = w_place.place_w(we, torch.cat([lstarts, lstarts[-1:]]), colbase, n_r * dr_s + 3)
    assert torch.equal(wide[:L, :, : n_r * dr_s], got)
    assert not wide[:, :, n_r * dr_s :].any() and not wide[L].any()


@pytest.mark.parametrize("dl", [3, 5])
def test_reduce_s_matches_pallas(dl):
    """B5's plain version against ``reduce_s`` in interpret mode (W
    components-major there, ``[dl, L, Dr]``): S and rhs within 1e-12."""
    rng = np.random.default_rng(dl)
    L, wc = 37, 20
    w = rng.standard_normal((L, dl, wc))
    a = rng.standard_normal((dl, dl, L))
    h_inv = np.linalg.inv(np.einsum("del,fel->ldf", a, a) + 2.0 * np.eye(dl)).transpose(1, 2, 0)
    g_l = rng.standard_normal((dl, L))
    ref = jax_reduce.reduce_s(jnp.asarray(w.transpose(1, 0, 2)), jnp.asarray(h_inv),
                              jnp.asarray(g_l), interpret=True)
    got = schur_reduce.reduce_s(*(torch.from_numpy(t) for t in (w, h_inv, g_l)))
    for name, x, y in zip(("s_sum", "rhs_sum"), got, ref):
        _close(x.numpy(), y, 1e-12, name)


CG = (nt.ContaminatedGaussian(), nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8),
      pt.ContaminatedGaussian())
BARRON = (nt.Barron(), nt.Barron.make_params(1.0, 1.0), pt.Barron())


def _data():
    """tests/test_adaptive.py's BAL problem: 6 cameras, 64 points, 4
    observations each, 10% of them moved by 50 pixels."""
    d = jbal.make_synthetic_bal(6, 64, obs_per_point=4, noise=1e-3)
    rng = np.random.default_rng(3)
    out = rng.choice(len(d["pt_idx"]), size=len(d["pt_idx"]) // 10, replace=False)
    d["observations"][out] += 50.0
    return d


def _pair(kernels=CG):
    """The JAX problem, and the port's built from its arrays
    (:func:`problem_from_arrays`: the kernel variable and the three-slot
    batch carried across)."""
    jk, kp, tk = kernels
    jp, _, jpts, jkh = jbal.make_bal_problem(_data(), kernel=jk, kernel_params=kp)
    jax_perturb_ba(jp, jpts, 0.01, seed=7)
    (jb,) = jp.batches()
    tp = problem_from_arrays(
        {k: np.asarray(v) for k, v in jp.stacked_variables().items()},
        [dict(fn=tbal.snavely_residual_cm, jacobian=tbal.snavely_jacobian_cm,
              manifolds=(tk.manifold, tbal.CAM, tbal.PT), idx=jb.idx,
              params=np.asarray(jb.params), mask=jb.mask, kernel=tk)],
        dtype=torch.float64, device="cpu",
    )
    return jp, jkh, tp


@pytest.fixture(scope="module")
def systems():
    """Both compiles of the ContaminatedGaussian problem and their
    assembled systems."""
    jp, _, tp = _pair()
    jc = jax_compile(jp, solver="schur", schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    return jc, tc, (cost_j, sys_j), (cost_t, sys_t)


def test_adaptive_system_matches_jax(systems):
    """cost, a_rr, b_r, h_ll, g_l and W (kernel columns included; B6's and
    B7's plain versions) against the JAX package's adaptive assembly,
    within 1e-10 relative; the problem carried across by
    ``problem_from_arrays`` is the port's own ``make_bal_problem``."""
    jc, tc, (cost_j, sys_j), (cost_t, sys_t) = systems
    f = jc.schur_info.fast[0]
    assert f.kernel_rows is not None
    (runs,) = tc.schur_info.fast
    assert np.array_equal(runs.kernel_rows, np.asarray(f.kernel_rows))
    assert runs.kernel_rows.tolist() == [54, 55, 56]  # after the 6 cameras
    for name, off in tc.layout.offsets.items():
        assert np.array_equal(off, np.asarray(jc.layout.offsets[name])), name
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b, 1e-10, name)
    _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), 1e-10, "w")
    # The kernel's rows are coupled to cameras and points.
    assert sys_t[4][:, :, 54:].abs().max() > 0 and sys_t[0][54:, :54].abs().max() > 0
    own, _, pts, _ = tbal.make_bal_problem(
        _data(), dtype=torch.float64, device="cpu", kernel=CG[2], kernel_params=CG[1])
    perturb_ba(own, pts, 0.01, seed=7)
    _close(pt.compile_problem(own, solver="schur", schur_family=tbal.PT).assemble(
        own.stacked_variables())[1][0].numpy(), sys_t[0].numpy(), 1e-12, "make_bal_problem")


def test_adaptive_damped_solve_matches_jax(systems, monkeypatch):
    """The damped step (f64-formed inverses, B5's plain version, Cholesky,
    back-substitution) against the JAX package's ``linops.solve`` with
    ``NLLSTPU_SOLVE_IMPL=pallas_interpret``, which reduces through its
    Pallas ``reduce_s`` over the standard-layout W: within 1e-9 of max|x|
    at λ ∈ {1e-2, 1}."""
    monkeypatch.setenv("NLLSTPU_SOLVE_IMPL", "pallas_interpret")
    jc, tc, (_, sys_j), (_, sys_t) = systems
    ops_t = tc.ctx().linops
    assert ops_t.pairs is not None
    for lam in (1e-2, 1.0):
        x_j = np.asarray(jc.ctx().linops.solve(sys_j, jnp.asarray(lam)))
        x_t = ops_t.solve(sys_t, lam).numpy()
        _close(x_t, x_j, 1e-9, f"lam={lam}")


@pytest.mark.parametrize("kernels", [CG, BARRON], ids=["ContaminatedGaussian", "Barron"])
def test_adaptive_lm_matches_jax(kernels):
    """LM through the direct Schur solve, 15 iterations: the same
    iterations, damped solves and termination as the JAX package, the cost
    after every iteration within 1e-9 relative, and the recovered kernel
    parameters within 1e-8 relative."""
    jp, jkh, tp = _pair(kernels)
    opts = dict(solver="schur", max_iters=15, rel_dcost=0.0)
    r_j = nt.optimize(jp, nt.Options(schur_family=jbal.PT, store_trajectory="jit", **opts))
    r_t = pt.optimize(tp, pt.Options(schur_family=tbal.PT, max_time=float("inf"), **opts))
    assert r_t.num_iterations == r_j.num_iterations
    assert r_t.linear_solves == r_j.linear_solves
    assert r_t.termination == r_j.termination
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
    assert r_t.best_cost < r_t.start_cost
    kh = pt.VarHandle(kernels[2].manifold, 0)
    np.testing.assert_allclose(tp.get_value(kh), np.asarray(jp.get_value(jkh)), rtol=1e-8)


def _two_kernel_problems():
    """The JAX and port problems of one components-major adaptive batch
    whose costs alternate between two kernel variables (4 cameras, 8
    points), the points perturbed alike."""
    d = jbal.make_synthetic_bal(4, 8)
    n = len(d["pt_idx"])
    out = []
    for pkg, bal, kern, kw in ((nt, jbal, CG[0], {}), (pt, tbal, CG[2], {"device": "cpu"})):
        p = pkg.Problem(**kw)
        p.add_variables(bal.CAM, d["cameras"])
        pts = p.add_variables(bal.PT, d["points"])
        k = [p.add_variable(kern.manifold, np.asarray(CG[1])).index for _ in range(2)]
        p.add_cost_batch(
            bal.snavely_residual_cm,
            [(kern.manifold, np.where(np.arange(n) % 2, k[0], k[1])),
             (bal.CAM, d["cam_idx"]), (bal.PT, d["pt_idx"])],
            params=d["observations"], kernel=kern, jacobian=bal.snavely_jacobian_cm,
            batched="cm",
        )
        (jax_perturb_ba if pkg is nt else perturb_ba)(p, pts, 0.01, seed=7)
        out.append(p)
    return out


def _system_step_trace(jp, tp, solver, lam=1e-2):
    """The assembled system (cost, a_rr, b_r, h_ll, g_l; W on the direct
    solve) within 1e-10, the damped step at ``lam`` within 32·κ·max(ε,
    PCG tolerance) of max|x| (κ of the JAX package's dense H + λI: each
    step lies within 16·κ·ε of the exact one) and two LM iterations (same
    counts, costs within 1e-9) against the JAX package's."""
    jc = jax_compile(jp, solver=solver, schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver=solver, schur_family=tbal.PT)
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b, 1e-10, name)
    if solver == "schur":
        _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), 1e-10, "w")
    ops_j = jc.ctx().linops
    if solver == "schur_cg":
        ops_j = dataclasses.replace(ops_j, tol=1e-12)
    x_j = np.asarray(ops_j.solve(sys_j, jnp.asarray(lam)))
    x_t = tc.ctx(pt.Options(linear_tol=1e-12)).linops.solve(sys_t, lam).numpy()
    _, (h, _) = jax.jit(jax_compile(jp, solver="dense").assemble)(jp.stacked_variables())
    ev = np.abs(np.linalg.eigvalsh(np.asarray(h) + lam * np.eye(h.shape[0])))
    kappa = ev.max() / ev.min()
    bound = 32 * kappa * max(np.finfo(np.float64).eps, 1e-12 if solver == "schur_cg" else 0.0)
    err = np.abs(x_t - x_j).max() / np.abs(x_j).max()
    assert err <= bound, f"step: {err:.3e} of max|x|, κ = {kappa:.3e}, bound {bound:.3e}"
    opts = dict(solver=solver, max_iters=2, rel_dcost=1e-6, linear_tol=1e-12)
    r_j = nt.optimize(jp, nt.Options(schur_family=jbal.PT, store_trajectory="jit", **opts))
    r_t = pt.optimize(tp, pt.Options(schur_family=tbal.PT, max_time=float("inf"), **opts))
    counts = [(r.num_iterations, r.linear_solves, r.termination) for r in (r_t, r_j)]
    assert counts[0] == counts[1], counts
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)


def test_two_kernel_variables_match_jax():
    """Two kernel variables in one batch (per-cost kernels, which the port
    refused before): the generic route with the kernel family as one more
    reduced family, against the JAX package's generic fall-through."""
    jp, tp = _two_kernel_problems()
    _system_step_trace(jp, tp, "schur")


def test_refuses_other_reduced_families():
    """A reduced variable outside the cameras and the kernel, which the
    port refused before its generic assembly: the system (cost, a_rr, b_r,
    h_ll, g_l, W) within 1e-10 and the damped step at λ = 1e-2 within
    1e-9 of the JAX package's."""
    data = jbal.make_synthetic_bal(4, 8, noise=1e-2)
    p, _, pts, _ = tbal.make_bal_problem(data, device="cpu", kernel=CG[2], kernel_params=CG[1])
    p.add_variable(pt.Euclidean(2), np.zeros(2))
    perturb_ba(p, pts, 0.01, seed=7)
    jp, _, jpts, _ = jbal.make_bal_problem(data, kernel=CG[0], kernel_params=CG[1])
    jp.add_variable(nt.Euclidean(2), np.zeros(2))
    jax_perturb_ba(jp, jpts, 0.01, seed=7)
    jc = jax_compile(jp, solver="schur", schur_family=jbal.PT)
    tc = pt.compile_problem(p, solver="schur", schur_family=tbal.PT)
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(p.stacked_variables())
    assert tc.schur_info.dim_reduced == 4 * 9 + 3 + 2
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b, 1e-10, name)
    _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), 1e-10, "w")
    x_j = np.asarray(jc.ctx().linops.solve(sys_j, jnp.asarray(1e-2)))
    _close(tc.ctx().linops.solve(sys_t, 1e-2).numpy(), x_j, 1e-9, "step")


def test_implicit_adaptive_matches_jax():
    """The 4/8 adaptive problem through the implicit backend (which the
    port refused before): the kernel's rows ride the coupling blocks beside
    the camera's, as in the JAX package's generic full-block wpart."""
    data = jbal.make_synthetic_bal(4, 8)
    tp, _, tpts, _ = tbal.make_bal_problem(data, device="cpu", kernel=CG[2], kernel_params=CG[1])
    perturb_ba(tp, tpts, 0.01, seed=7)
    jp, _, jpts, _ = jbal.make_bal_problem(data, kernel=CG[0], kernel_params=CG[1])
    jax_perturb_ba(jp, jpts, 0.01, seed=7)
    _system_step_trace(jp, tp, "schur_cg")
