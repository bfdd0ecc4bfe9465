"""The port's generic Schur assembly against the JAX package, on the CPU
in float64: per-cost, row-major and components-major batches, priors,
pose-graph-like edges between cameras, a second reduced family, fixed
cameras and fixed landmarks, on the direct solve (the keyed sums through
kernel B6's plain version, W placed by B7's, the solve through B5's) and
on the implicit one (the Schur-Jacobi rule per family); the obs-major
route with riders and fixed landmarks in its extras region (B1's and B2's
plain versions); fixed cameras on the adaptive path; ``solver="auto"``;
and the JAX package's own refusal of two eliminated slots in one cost.

Tolerances: assembled systems within 1e-12 of the largest entry (the
same float64 arithmetic, summed in another order); damped solves within
1e-9 of the largest entry; Levenberg-Marquardt traces within 1e-9
relative per iteration, with the same iteration and solve counts and
termination, each run stopped (``rel_dcost=1e-6``) before the rounding
floor, where a 1e-16 change is accepted or rejected by rounding alone.
One JAX run serves several checks through module-scoped fixtures."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core.linearsolver import batched_inv_spd_cm as jax_inv_cm
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import make_affine_ba as jax_affine
from nllstpu.models.ba import make_pinhole_ba as jax_pinhole
from nllstpu.models.ba import perturb_ba as jax_perturb
import nllstpu_torch as pt
import nllstpu_torch.core.optimize as pt_optimize
from nllstpu_torch.interop import problem_from_arrays
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_affine_ba, make_pinhole_ba, perturb_ba
from nllstpu_torch.ops import schur

LMK = (nt.Euclidean(3), pt.Euclidean(3))
SYSTEM = ("a_rr", "b_r", "h_ll", "g_l")


def _close(got, ref, tol, msg=""):
    """Within ``tol`` of the largest entry of ``ref``."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max(), err_msg=msg)


def _systems(jp, tp, juf, tuf, fam, solver="schur"):
    """Both compiles and their assembled systems (the JAX one jitted)."""
    jc = jax_compile(jp, unfixed=juf, solver=solver, schur_family=fam[0])
    tc = pt.compile_problem(tp, tuf, solver=solver, schur_family=fam[1])
    for name, off in tc.layout.offsets.items():
        assert np.array_equal(off, np.asarray(jc.layout.offsets[name])), name
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    return jc, tc, (cost_j, sys_j), (cost_t, sys_t)


def _check_system(pair, w=True):
    _, _, (cost_j, sys_j), (cost_t, sys_t) = pair
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip(SYSTEM, sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b, 1e-12, name)
    if w:  # the JAX package's W is [dl, L, Dr], the port's [L, dl, Dr]
        _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), 1e-12, "w")


def _check_solves(pair, lams=(1e-4, 1.0)):
    jc, tc, (_, sys_j), (_, sys_t) = pair
    solve_j, ops_t = jax.jit(jc.schur_info.ops().solve), tc.ctx().linops
    for lam in lams:
        x_j = np.asarray(solve_j(sys_j, jnp.asarray(lam)))
        _close(ops_t.solve(sys_t, lam).numpy(), x_j, 1e-9, f"lam={lam}")


# -- the affine BA with a fixed camera and two fixed landmarks -------------


@pytest.fixture(scope="module")
def affine():
    """tests/test_schur.py's mixed-fixing case: make_affine_ba(4, 9, 0.6),
    one camera and two landmarks fixed."""
    jp, jc, jl = jax_affine(4, 9, 0.6)
    jax_perturb(jp, jl, 0.05, seed=3)
    tp, tc, tl = make_affine_ba(4, 9, 0.6, device="cpu")
    perturb_ba(tp, tl, 0.05, seed=3)
    return _systems(jp, tp, jc[1:] + jl[:-2], tc[1:] + tl[:-2], LMK)


def test_affine_fixed_system_matches_jax(affine):
    """Single costs (a per-cost batch) with a fixed camera and two fixed
    landmarks take the generic route: B5's tables, no obs-major tables."""
    _check_system(affine)
    info = affine[1].schur_info
    assert all(isinstance(f, schur._GenBatch) for f in info.fast)
    assert info.w_pairs is not None and info.w_rows is None


def test_affine_fixed_solves_match_jax(affine):
    _check_solves(affine)


# -- a second reduced family, camera-camera edges and priors ---------------


def _j_offset(m, pose, off, x):
    return jnp.stack([pose[:3] @ x, pose[3:] @ x]) + off - m


def _t_offset(m, pose, off, x):
    return torch.stack([pose[:3] @ x, pose[3:] @ x]) + off - m


def _difference(m, a, b):
    return a - b - m


def _prior(m, x):
    return x - m


def _mixed(jax_side):
    """Affine BA plus a second reduced family (two 2-vector offsets) in
    three-slot costs (camera, offset, landmark), camera-camera edges (one
    from a camera to itself), a camera prior and point priors."""
    if jax_side:
        p, cams, lmks = jax_affine(4, 9, 0.6)
        jax_perturb(p, lmks, 0.05, seed=3)
        jax_perturb(p, cams, 0.02, seed=4)
        euc, offset = nt.Euclidean, _j_offset
    else:
        p, cams, lmks = make_affine_ba(4, 9, 0.6, device="cpu")
        perturb_ba(p, lmks, 0.05, seed=3)
        perturb_ba(p, cams, 0.02, seed=4)
        euc, offset = pt.Euclidean, _t_offset
    rng = np.random.default_rng(5)
    offs = [p.add_variable(euc(2), rng.standard_normal(2) * 0.1) for _ in range(2)]
    for k in range(6):
        p.add_cost(offset, (cams[k % 4], offs[k % 2], lmks[(3 * k) % 9]),
                   params=rng.standard_normal(2))
    for a, b in ((0, 1), (1, 2), (2, 3), (3, 0), (1, 1)):
        p.add_cost(_difference, (cams[a], cams[b]), params=rng.standard_normal(6) * 0.1)
    p.add_cost(_prior, (cams[2],), params=np.asarray(p.get_value(cams[2])) + 0.01)
    for li in (0, 4, 7):
        p.add_cost(_prior, (lmks[li],), params=np.asarray(p.get_value(lmks[li])) + 0.02)
    return p, cams[1:] + lmks[:-2] + offs


@pytest.fixture(scope="module", params=["schur", "schur_cg"])
def mixed(request):
    (jp, juf), (tp, tuf) = _mixed(True), _mixed(False)
    return request.param, _systems(jp, tp, juf, tuf, LMK, solver=request.param)


def test_mixed_system_matches_jax(mixed):
    """Five batches (two-slot, three-slot over two reduced families, edges,
    camera prior, point priors), every one generic; a_rr's off-diagonal
    camera blocks and the offsets' rows included."""
    solver, pair = mixed
    _check_system(pair, w=solver == "schur")
    info = pair[1].schur_info
    assert [(n, b, k, d) for n, b, k, d in info.fams] == [
        ("Euclidean(n=6)", 0, 3, 6), ("Euclidean(n=2)", 18, 2, 2)]
    assert all(isinstance(f, schur._GenBatch) for f in info.fast)
    assert pair[3][1][0][:18, 18:].abs().max() > 0  # camera-offset coupling


def test_mixed_solves_match_jax(mixed):
    """The direct solve (B5's plain version) at λ ∈ {1e-4, 1}, and the
    implicit PCG at the JAX package's tolerance at λ = 1e-3; the implicit
    preconditioner corrects the cameras (a two-slot coupling batch) and not
    the offsets (only the three-slot one), as the JAX package's does."""
    solver, pair = mixed
    _check_solves(pair, lams=(1e-4, 1.0) if solver == "schur" else (1e-3,))
    if solver == "schur_cg":
        jc, tc, (_, sys_j), (_, sys_t) = pair
        lam = 1e-3
        ops_t = tc.ctx().linops
        _, _, corrected = ops_t.precond_blocks(sys_t, lam, ops_t.damped_inverse(sys_t[2], lam))
        h_inv = jax_inv_cm(sys_j[2] + lam * jnp.eye(3)[:, :, None])
        _, corrected_j = jc.schur_info.ops().precond_blocks(sys_j, lam, h_inv)
        assert corrected == list(corrected_j) == [True, False]


def test_two_eliminated_slots_raise():
    """A cost over two landmarks: ``ValueError``, as the JAX package's
    assembly raises it."""
    jp, _, jl = jax_affine(3, 5)
    jp.add_cost(_difference, (jl[0], jl[1]), params=np.zeros(3))
    jc = jax_compile(jp, solver="schur", schur_family=LMK[0])
    with pytest.raises(ValueError, match="at most one eliminated variable"):
        jax.jit(jc.assemble)(jp.stacked_variables())
    tp, _, tl = make_affine_ba(3, 5, device="cpu")
    tp.add_cost(_difference, (tl[0], tl[1]), params=np.zeros(3))
    for solver in ("schur", "schur_cg"):
        with pytest.raises(ValueError, match="at most one eliminated variable"):
            pt.compile_problem(tp, solver=solver, schur_family=LMK[1])


# -- the obs-major route with riders ---------------------------------------


def _translation_prior(m, pose):
    return pose[:, 3] - m


def _add_riders(p, cams, lmks, cam_prior):
    """A camera prior and three point priors (per-cost batches)."""
    c = np.asarray(p.get_value(cams[3]))
    if cam_prior:
        p.add_cost(_translation_prior, (cams[3],), params=c[:, 3] + 0.01)
    else:
        p.add_cost(_prior, (cams[3],), params=c + 0.01)
    for li in (2, 5, 9):
        p.add_cost(_prior, (lmks[li],), params=np.asarray(p.get_value(lmks[li])) + 0.02)


def _rider_case(layout):
    """A components-major batch with riders, its first camera and its
    three lowest landmarks fixed: the uniform pinhole layout (kernel B1)
    or a degree-bucketed BAL one (kernel B2)."""
    if layout == "uniform":
        kw = dict(noise=1e-3, batched="cm", robust_width=0.01)
        jp, jc, jl = jax_pinhole(6, 41, 0.6, dtype=jnp.float64, **kw)
        tp, tc, tl = make_pinhole_ba(6, 41, 0.6, dtype=torch.float64, device="cpu", **kw)
        jax_perturb(jp, jl, 0.05, seed=7)
        perturb_ba(tp, tl, 0.05, seed=7)
        fam = LMK
    else:
        shape = dict(ncameras=12, npoints=160, seed=3, noise=1e-3)
        jp, jc, jl = jbal.make_bal_problem(jbal.make_realistic_bal(**shape), dtype=jnp.float64)
        tp, tc, tl = tbal.make_bal_problem(tbal.make_realistic_bal(**shape),
                                           dtype=torch.float64, device="cpu")
        jax_perturb(jp, jl, 0.05, seed=5)
        perturb_ba(tp, tl, 0.05, seed=5)
        fam = (jbal.PT, tbal.PT)
    _add_riders(jp, jc, jl, layout == "uniform")
    _add_riders(tp, tc, tl, layout == "uniform")
    return _systems(jp, tp, jc[1:] + jl[3:], tc[1:] + tl[3:], fam)


@pytest.mark.parametrize("layout", ["uniform", "buckets"])
def test_riders_on_the_obs_major_route_match_jax(layout):
    """The obs-major route keeps the coupling batch (B1's or B2's plain
    version, ``info.w_rows`` set) and adds the priors' blocks through the
    generic sums; the fixed landmarks' costs sit in the extras region and
    add to a_rr and b_r only.  The system within 1e-12, the damped steps
    within 1e-9."""
    pair = _rider_case(layout)
    info = pair[1].schur_info
    assert info.w_rows is not None and info.w_pairs is None
    fast, *riders = info.fast
    assert isinstance(fast, schur._FastBatch) and len(fast.buckets) == (
        1 if layout == "uniform" else 4)
    assert fast.ex_cols.shape[0] > 0
    assert all(isinstance(f, schur._GenBatch) for f in riders)
    assert info.plan.w == () and info.plan.l is not None
    _check_system(pair)
    _check_solves(pair)


# -- Levenberg-Marquardt through the generic route -------------------------


def _lm(jp, tp, juf, tuf, fam, solver="schur"):
    opts = dict(solver=solver, rel_dcost=1e-6)
    r_j = nt.optimize(jp, nt.Options(schur_family=fam[0], store_trajectory="jit", **opts),
                      unfixed=juf)
    r_t = pt.optimize(tp, pt.Options(schur_family=fam[1], max_time=float("inf"), **opts),
                      unfixed=tuf)
    assert r_t.num_iterations == r_j.num_iterations >= 2
    assert r_t.linear_solves == r_j.linear_solves
    assert r_t.termination == r_j.termination
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
    return r_t


@pytest.mark.parametrize("batched", [False, True], ids=["per-cost", "row-major"])
def test_pinhole_forms_lm_matches_jax(batched):
    """``make_pinhole_ba(8, 64, batched=False, hand_jacobian=False)`` (per
    cost, autodiff Jacobians) and ``batched=True`` (row-major, hand
    Jacobian) through ``solver="schur"``, the first camera fixed."""
    kw = dict(noise=1e-3, batched=batched, hand_jacobian=batched)
    jp, jc, jl = jax_pinhole(8, 64, 0.7, dtype=jnp.float64, **kw)
    tp, tc, tl = make_pinhole_ba(8, 64, 0.7, dtype=torch.float64, device="cpu", **kw)
    jax_perturb(jp, jl, 0.03, seed=2)
    perturb_ba(tp, tl, 0.03, seed=2)
    _lm(jp, tp, jc[1:] + jl, tc[1:] + tl, LMK)


BAL_SHAPE = dict(ncameras=8, npoints=80, seed=3, noise=1e-3)


def test_bal_per_cost_lm_matches_jax():
    """``make_bal_problem(batched=False)`` (per cost, autodiff Jacobians)
    through ``solver="schur"``, a camera and three landmarks fixed."""
    jp, jc, jl = jbal.make_bal_problem(jbal.make_realistic_bal(**BAL_SHAPE), dtype=jnp.float64,
                                       batched=False)
    tp, tc, tl = tbal.make_bal_problem(tbal.make_realistic_bal(**BAL_SHAPE), dtype=torch.float64,
                                       device="cpu", batched=False)
    jax_perturb(jp, jl, 0.05, seed=5)
    perturb_ba(tp, tl, 0.05, seed=5)
    _lm(jp, tp, jc[1:] + jl[3:], tc[1:] + tl[3:], (jbal.PT, tbal.PT))


def test_bal_autodiff_cm_matches_jax_on_the_obs_major_route():
    """``make_bal_problem(hand_jacobian=False)`` (components-major, the
    Jacobian synthesized) stays on the obs-major route (one B2 batch) and
    matches the JAX package's system within 1e-9, and the port's own
    hand-Jacobian system within 1e-9."""
    data = jbal.make_realistic_bal(**BAL_SHAPE)
    jp, _, jl = jbal.make_bal_problem(data, dtype=jnp.float64, hand_jacobian=False)
    jax_perturb(jp, jl, 0.05, seed=5)
    built = []
    for hand in (False, True):
        tp, _, tl = tbal.make_bal_problem(data, dtype=torch.float64, device="cpu",
                                          hand_jacobian=hand)
        perturb_ba(tp, tl, 0.05, seed=5)
        built.append(tp)
    pair = _systems(jp, built[0], None, None, (jbal.PT, tbal.PT))
    (fast,) = pair[1].schur_info.fast
    assert isinstance(fast, schur._FastBatch) and pair[1].schur_info.w_rows is not None
    _, _, (cost_j, sys_j), (cost_t, sys_t) = pair
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip(SYSTEM, sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b, 1e-9, name)
    _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), 1e-9, "w")
    hand = pt.compile_problem(built[1], solver="schur", schur_family=tbal.PT)
    _, sys_h = hand.assemble(built[1].stacked_variables())
    for name, a, b in zip(SYSTEM + ("w",), sys_t, sys_h):
        _close(a.numpy(), b.numpy(), 1e-9, f"hand {name}")


# -- the implicit backend on components-major batches with fixed cameras ---


def test_implicit_fixed_cameras_solve_matches_jax():
    """A components-major pinhole batch through ``solver="schur_cg"`` with
    two cameras and two landmarks fixed: the PCG step at λ = 1e-3 within
    1e-9, and the cameras' preconditioner corrected as in the JAX run."""
    kw = dict(noise=1e-3, batched="cm")
    jp, jc, jl = jax_pinhole(6, 40, 0.7, dtype=jnp.float64, **kw)
    tp, tc, tl = make_pinhole_ba(6, 40, 0.7, dtype=torch.float64, device="cpu", **kw)
    jax_perturb(jp, jl, 0.03, seed=2)
    perturb_ba(tp, tl, 0.03, seed=2)
    pair = _systems(jp, tp, jc[2:] + jl[2:], tc[2:] + tl[2:], LMK, solver="schur_cg")
    _check_system(pair, w=False)
    _check_solves(pair, lams=(1e-3,))
    (runs,) = pair[1].schur_info.fast
    assert isinstance(runs, schur._RunBatch) and runs.n_r == 4


# -- fixed cameras on the adaptive path ------------------------------------


def test_adaptive_fixed_cameras_match_jax():
    """tests/test_torch_adaptive.py's ContaminatedGaussian problem with its
    first camera fixed: the system within 1e-10 (the adaptive tests'
    tolerance) and the damped step at λ ∈ {1e-2, 1} within 1e-9."""
    d = jbal.make_synthetic_bal(6, 64, obs_per_point=4, noise=1e-3)
    rng = np.random.default_rng(3)
    d["observations"][rng.choice(len(d["pt_idx"]), len(d["pt_idx"]) // 10, replace=False)] += 50
    params = nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8)
    jp, jc, jl, jkh = jbal.make_bal_problem(d, kernel=nt.ContaminatedGaussian(),
                                            kernel_params=params)
    jax_perturb(jp, jl, 0.01, seed=7)
    (jb,) = jp.batches()
    tk = pt.ContaminatedGaussian()
    tp = problem_from_arrays(
        {k: np.asarray(v) for k, v in jp.stacked_variables().items()},
        [dict(fn=tbal.snavely_residual_cm, jacobian=tbal.snavely_jacobian_cm,
              manifolds=(tk.manifold, tbal.CAM, tbal.PT), idx=jb.idx,
              params=np.asarray(jb.params), mask=jb.mask, kernel=tk)],
        dtype=torch.float64, device="cpu",
    )
    tuf = ([pt.VarHandle(tbal.CAM, i) for i in range(1, 6)]
           + [pt.VarHandle(tbal.PT, i) for i in range(64)] + [pt.VarHandle(tk.manifold, 0)])
    jc_, tc_, (cost_j, sys_j), (cost_t, sys_t) = _systems(
        jp, tp, jc[1:] + jl + [jkh], tuf, (jbal.PT, tbal.PT))
    (runs,) = tc_.schur_info.fast
    assert isinstance(runs, schur._RunBatch) and runs.n_r == 5
    assert runs.kernel_rows.tolist() == [45, 46, 47]  # after the five free cameras
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip(SYSTEM, sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b, 1e-10, name)
    _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), 1e-10, "w")
    _check_solves((jc_, tc_, (cost_j, sys_j), (cost_t, sys_t)), lams=(1e-2, 1.0))


# -- solver="auto" ----------------------------------------------------------


@pytest.mark.parametrize("nlmk", [50, 80])
def test_auto_picks_and_follows_jax(nlmk):
    """``solver="auto"`` on ``make_affine_ba(10, nlmk, 0.3)`` (single
    costs): the backend and eliminated family the JAX package picks (50
    landmarks are too few for its Schur rule: "cg"; 80 take the generic
    Schur route), and its LM trace.  The measurements are noise-free, so
    the cost falls by three to six decades an iteration; two iterations
    stay above the rounding floor."""
    jp, jc, jl = jax_affine(10, nlmk, 0.3)
    jax_perturb(jp, jl, 0.05, seed=3)
    jax_perturb(jp, jc, 0.025, seed=4)
    tp, tc, tl = make_affine_ba(10, nlmk, 0.3, device="cpu")
    perturb_ba(tp, tl, 0.05, seed=3)
    perturb_ba(tp, tc, 0.025, seed=4)
    jcomp = jax_compile(jp, solver="auto")
    solver, fam = pt_optimize.auto_solver(tp)
    expect = "schur" if jcomp.schur_info is not None else "cg"
    assert solver == expect == ("schur" if nlmk == 80 else "cg")
    if fam is not None:
        assert pt.family_name(fam) == jcomp.schur_info.elim_family
    opts = dict(solver="auto", rel_dcost=1e-6, max_iters=2)
    r_j = nt.optimize(jp, nt.Options(store_trajectory="jit", **opts))
    r_t = pt.optimize(tp, pt.Options(max_time=float("inf"), **opts))
    assert r_t.num_iterations == r_j.num_iterations and r_t.linear_solves == r_j.linear_solves
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
