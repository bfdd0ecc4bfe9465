"""Every obs-major shape the JAX kernels take, on the CPU: the route that
``compile_problem`` records (the same on every device: kernels B1, B2 and
B8 take every (n residual rows, camera dof, landmark dof) whose warp
region fits a block's shared memory, ``fused_obs.kernel_takes``; any other
batch, or an adaptive one, takes the generic route), the obs-major block
tables of a camera wider than 16 dof, the direct compile of an eliminated family past the unrolled
instances of B4 and B5 (dl 17, against the JAX package), the plain
versions of B1 and B8 at (2, 6, 2) against the JAX package's
interpret-mode kernels, and float64 LM traces of a planar (dl = 2) and a
stereo (three-row) problem against the JAX package.  The problems are ``scripts_torch/shapes_reference.py``'s.

Tolerances: the assembled systems to ``test_assemble_fused_all_dl2``'s
rtol 1e-12, atol 1e-13 (the same float64 arithmetic, summed in another
order); the LM traces to 1e-9 relative with the same iterations, solves
and termination, as the port's other float64 trace tests, stopping at
``rel_dcost=1e-6`` before the float64 floor; the hand Jacobians to 1e-12
of the largest entry against ``auto_cm_jacobian``'s forward mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nllstpu as nt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
import nllstpu_torch as pt
from nllstpu_torch.core.problem import auto_cm_jacobian
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.models.bal import make_realistic_bal
from nllstpu_torch.ops import fused_obs, schur, schur_reduce
from scripts_torch import shapes_reference as sr

TOL = dict(rtol=1e-12, atol=1e-13)


def _linear_problem(n, dr, dl, dtype=torch.float64, seed=0, pkg=pt, adaptive=False):
    """A components-major camera/landmark batch of shape (n, dr, dl):
    residual row i = cam[i mod dr]·x[i mod dl] + x[(i + 1) mod dl] − m_i
    over a banded pattern of 6 cameras and 40 landmarks, the Jacobian
    synthesized; in the port (on the CPU) or, with ``pkg=nt``, the JAX
    package; ``adaptive``: under one shared ContaminatedGaussian."""
    rng = np.random.default_rng(seed)
    cams, pts = rng.standard_normal((6, dr)) + 1.0, rng.standard_normal((40, dl))
    ci, li = np.nonzero(sr.banded_visibility(6, 40, 0.6))
    xp = torch if pkg is pt else jnp

    def residual(meas, cam, x):
        return xp.stack([cam[i % dr] * x[i % dl] + x[(i + 1) % dl] - meas[:, i]
                         for i in range(n)])

    p = pt.Problem(dtype=dtype, device="cpu") if pkg is pt else nt.Problem(dtype=dtype)
    cam_m, pt_m = pkg.Euclidean(dr), pkg.Euclidean(dl)
    p.add_variables(cam_m, cams)
    p.add_variables(pt_m, pts)
    slots, kernel = [(cam_m, ci), (pt_m, li)], None
    if adaptive:
        kernel = pkg.ContaminatedGaussian()
        kh = p.add_variable(kernel.manifold, pkg.ContaminatedGaussian.make_params(1.0, 10.0, 0.8))
        slots = [(kernel.manifold, np.full(len(ci), kh.index, np.int32))] + slots
    p.add_cost_batch(residual, slots=slots, params=rng.standard_normal((len(ci), n)),
                     kernel=kernel, batched="cm")
    return p, pt_m


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,obs_major", [
    ((2, 6, 3), True), ((2, 9, 3), True), ((2, 6, 2), True), ((3, 9, 3), True),
    ((5, 6, 3), True), ((2, 6, 9), True), ((2, 6, 18), True), ((2, 17, 3), True),
    ((8, 6, 200), False),
])
def test_route_follows_kernel_takes(shape, obs_major, dtype):
    """``compile_problem(device="cpu")`` records the route a card compile
    takes: the obs-major route (B1) where ``kernel_takes`` holds for the
    batch's (n, dr_s, dl) and dtype — NRSfM's shapes among them, past the
    old caps n ≤ 4, dr_s ≤ 16, dl ≤ 6 — else the generic route (B6, B7,
    B5), whose reason names the shared memory a warp would take, and on
    which ``w_impl="fused"`` is refused in those words."""
    n, dr, dl = shape
    assert fused_obs.kernel_takes(n, dr, dl, dtype) == obs_major
    problem, fam = _linear_problem(n, dr, dl, dtype)
    assert schur.residual_rows(problem.batches()[0]) == n
    comp = pt.compile_problem(problem, solver="schur", schur_family=fam)
    info = comp.schur_info
    kind = schur._FastBatch if obs_major else schur._GenBatch
    assert isinstance(info.fast[0], kind)
    assert (info.w_rows is not None, info.w_pairs is not None) == (obs_major, not obs_major)
    if obs_major:
        assert info.fast[0].dr_s == dr and not info.generic_why
        return
    plan = fused_obs.any_shape_plan(n, dr, dl, dtype)
    assert plan.warps == 0 and plan.warp_bytes > fused_obs.SMEM_LIMIT
    assert "do not take its shape (n=8, dr_s=6, dl=200" in info.generic_why
    assert f"take {plan.warp_bytes} bytes of shared memory" in info.generic_why
    with pytest.raises(NotImplementedError, match="do not take its shape"):
        pt.compile_problem(problem, solver="schur", schur_family=fam, w_impl="fused")


def test_adaptive_batch_takes_the_generic_route():
    """A batch under an adaptive kernel takes the generic route at a shape
    the kernels take, as in the JAX package, and ``w_impl="fused"`` is
    refused on it."""
    problem, fam = _linear_problem(2, 6, 3, adaptive=True)
    info = pt.compile_problem(problem, solver="schur", schur_family=fam).schur_info
    assert not isinstance(info.fast[0], schur._FastBatch) and info.w_pairs is not None
    with pytest.raises(NotImplementedError, match="it is not obs-major"):
        pt.compile_problem(problem, solver="schur", schur_family=fam, w_impl="fused")


def test_wide_blocks():
    """A camera of 17 dof is past the old dr_s ≤ 16, and its batch now takes
    the obs-major route, whose block tables cut each camera block wider
    than ``schur_reduce.MAX_WIDTH`` into pieces (16 + 1 columns here): no
    table holds a block wider than 16, and the pieces cover W.  A landmark
    of 17 dof (21 residual rows, so that every landmark block has full
    rank) is past the unrolled instances of B4 and B5 and takes their
    tiled one: the direct compile takes it through the obs-major route (B1
    at (21, 6, 17)), and its float64 LM follows the JAX package's direct
    solve over four iterations (costs within 1e-9, the same solves); the
    implicit solve takes it too."""
    problem, fam = _linear_problem(2, 17, 2)
    comp = pt.compile_problem(problem, solver="schur", schur_family=fam)
    rows = comp.schur_info.w_rows
    assert isinstance(comp.schur_info.fast[0], schur._FastBatch)
    assert rows.max_width == schur_reduce.MAX_WIDTH == 16
    assert np.asarray(rows.bwidth).tolist() == [16, 1] * 6
    assert rows.covered == rows.n_cols == 6 * 17
    problem, fam = _linear_problem(21, 6, 17)
    comp = pt.compile_problem(problem, solver="schur", schur_family=fam)
    info = comp.schur_info
    assert not info.implicit and info.dof_elim == 17 and info.w_rows is not None
    opts = dict(max_iters=4, rel_dcost=0.0, abs_dcost=0.0, max_time=float("inf"))
    r_t = pt.optimize(problem, pt.Options(solver="schur", schur_family=fam, **opts))
    jp, jfam = _linear_problem(21, 6, 17, jnp.float64, pkg=nt)
    r_j = nt.optimize(jp, nt.Options(solver="schur", schur_family=jfam,
                                     store_trajectory="jit", **opts))
    counts = [(r.num_iterations, r.linear_solves) for r in (r_t, r_j)]
    assert counts[0] == counts[1] and counts[0][0] == 4, counts
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
    comp = pt.compile_problem(problem, solver="schur_cg", schur_family=fam)
    assert comp.schur_info.implicit


@pytest.mark.parametrize("kind", ["planar", "stereo"])
def test_hand_jacobian_matches_autodiff(kind):
    """The hand components-major Jacobians of both problems against the
    synthesized one (forward mode through the residual), at the
    generators' geometry with rotations well past the small-angle
    series."""
    if kind == "planar":
        data, dofs = sr.planar_data(8, 64, 0.5), (6, 2)
        residual, jacobian = sr.planar_model(torch)
    else:
        data, dofs = sr.stereo_data(make_realistic_bal(12, 300, seed=1, noise=1e-3)), (9, 3)
        residual, jacobian = sr.stereo_model(torch)
    cam = torch.as_tensor(data["cameras"][data["cam_idx"]].T)
    cam[:3] *= 1 + 2 * (kind == "stereo")
    x = torch.as_tensor(data["points"][data["pt_idx"]].T)
    meas = torch.as_tensor(data["observations"])
    r, j = jacobian(meas, cam, x)
    r_a, j_a = auto_cm_jacobian(residual, tuple(pt.Euclidean(d) for d in dofs))(meas, cam, x)
    assert j.shape == (2 + (kind == "stereo"), sum(dofs), meas.shape[0])
    assert torch.equal(r, r_a)
    assert float((j - j_a).abs().max()) <= 1e-12 * float(j_a.abs().max())


def _dl2_problem(pkg, dtype, device=None):
    """``test_assemble_fused_all_dl2``'s problem (4 affine cameras, 20
    2-D landmarks, every landmark seen by every camera) in ``pkg``."""
    rng = np.random.default_rng(11)
    cam0 = rng.standard_normal((4, 6)) * 0.2 + np.array([1.0, 0, 0, 1.0, 0, 0])
    lmk0 = rng.standard_normal((20, 2))
    ci = np.tile(np.arange(4), 20)
    li = np.repeat(np.arange(20), 4)
    meas = []
    for c, l in zip(ci, li):
        a = cam0[c]
        meas.append(np.array([[a[0], a[1]], [a[2], a[3]]]) @ lmk0[l] + a[4:]
                    + 0.01 * rng.standard_normal(2))
    data = dict(cameras=cam0, points=lmk0, cam_idx=ci, pt_idx=li, observations=np.array(meas))
    return sr.build(pkg, "planar", data, dtype, device)[0]


@pytest.mark.parametrize("w_impl,jax_impl,kernel", [
    ("fused_all", "fused_all_interpret", "B1"), ("fused", "fused_interpret", "B8"),
])
def test_dl2_system_matches_pallas(monkeypatch, w_impl, jax_impl, kernel):
    """The port's whole system at (2, 6, 2) — B1's plain version (with B6's
    over the camera runs), or B8's and the camera-major leg — against the
    JAX package's assembly through its interpret-mode kernel on
    ``test_assemble_fused_all_dl2``'s problem, W through its basis
    gather."""
    monkeypatch.setenv("NLLSTPU_W_IMPL", jax_impl)
    jp = _dl2_problem(nt, jnp.float64)
    jcomp = jax_compile(jp, solver="schur", schur_family=nt.Euclidean(2))
    assert jcomp.schur_info.w_pm is not None
    cost_j, sys_j = jax.jit(jcomp.assemble)(jp.stacked_variables())
    tp = _dl2_problem(pt, torch.float64, "cpu")
    tcomp = pt.compile_problem(tp, solver="schur", schur_family=pt.Euclidean(2), w_impl=w_impl)
    fast = tcomp.schur_info.fast[0]
    assert isinstance(fast, schur._FastBatch) and (fast.dr_s, tcomp.schur_info.dof_elim) == (6, 2)
    counts = {}

    def counting(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_obs, "fused_obs_all_reference",
                        counting(fused_obs.fused_obs_all_reference))
    monkeypatch.setattr(fused_obs, "fused_obs_leg_reference",
                        counting(fused_obs.fused_obs_leg_reference))
    cost_t, sys_t = tcomp.assemble(tp.stacked_variables())
    assert list(counts) == [{"B1": "fused_obs_all_reference",
                             "B8": "fused_obs_leg_reference"}[kernel]]
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-14)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    _, _, _, pm_of_std = jcomp.schur_info.w_pm
    np.testing.assert_allclose(
        sys_t[4].permute(1, 0, 2).numpy(),
        np.asarray(sys_j[4]).transpose(0, 2, 1)[:, :, pm_of_std], **TOL,
    )


@pytest.mark.parametrize("kind", ["planar", "stereo"])
def test_lm_trace_matches_jax(kind):
    """Float64 LM through the obs-major route — planar (8 cameras, 64
    landmarks, B1 at (2, 6, 2), B4 at dl = 2) and stereo
    (``make_realistic_bal(12, 300, seed=1)``'s pattern, 4 degree buckets,
    B2 at (3, 9, 3), B4) — against the JAX package: the same iterations,
    solves and termination, the cost trace within 1e-9 relative."""
    if kind == "planar":
        data, fam = sr.planar_data(8, 64, 0.5), 2
    else:
        data, fam = sr.stereo_data(make_realistic_bal(12, 300, seed=1, noise=1e-3)), 3
    jp, _, jpts = sr.build(nt, kind, data, jnp.float64)
    jax_perturb_ba(jp, jpts, 0.05, seed=5)
    tp, _, tpts = sr.build(pt, kind, data, torch.float64, "cpu")
    perturb_ba(tp, tpts, 0.05, seed=5)
    comp = pt.compile_problem(tp, solver="schur", schur_family=pt.Euclidean(fam))
    fast = comp.schur_info.fast[0]
    assert isinstance(fast, schur._FastBatch)
    assert (fast.slots is None) == (kind == "planar")  # B1 (one bucket) or B2
    r_j = nt.optimize(jp, nt.Options(solver="schur", schur_family=nt.Euclidean(fam),
                                     rel_dcost=1e-6, store_trajectory="jit"))
    r_t = pt.optimize(tp, pt.Options(solver="schur", schur_family=pt.Euclidean(fam),
                                     rel_dcost=1e-6, max_time=float("inf")))
    counts = [(r.num_iterations, r.linear_solves, r.termination) for r in (r_t, r_j)]
    assert counts[0] == counts[1], counts
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
    assert r_t.best_cost < 1e-2 * r_t.start_cost
