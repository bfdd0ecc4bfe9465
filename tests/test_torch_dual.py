"""The port's fifth slice against the JAX package, on the CPU in float64:
fixed variables (``unfixed=``), the dual-sorted direct assembly
(``w_impl="fused"``: kernel B8's plain version over the landmark runs and
the camera-major leg) and the float64 solve over external inverses
(kernel B4's plain version).  The Pallas kernels run in interpret mode.

Tolerances: B8's and B4's plain versions and the assembled system
against the JAX package to 1e-12 (the same float64 arithmetic, summed in
another order); the gauge-fixed Levenberg-Marquardt trace to 1e-10
relative per iteration, with the same iteration count."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core import engine as jax_engine
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import make_pinhole_ba as jax_make_ba
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.ops.pallas.fused_obs import fused_obs_leg_pm
from nllstpu.ops.pallas.schur_reduce import reduce_s_lm as jax_reduce_s_lm
import nllstpu_torch as pt
from nllstpu_torch.core import engine
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
from nllstpu_torch.ops import fused_obs, schur, schur_reduce

TOL = dict(rtol=1e-12, atol=1e-13)


def _pair(ncam, nlmk, seed, vis=0.7):
    """The same perturbed pinhole problem in both packages, and each
    package's ``(cameras, landmarks)`` handles."""
    jp, jc, jl = jax_make_ba(ncam, nlmk, vis, noise=1e-3, dtype=jnp.float64, batched="cm")
    jax_perturb_ba(jp, jl, 0.03, seed=seed)
    tp, tc, tl = make_pinhole_ba(ncam, nlmk, vis, noise=1e-3, dtype=torch.float64, batched="cm",
                                 device="cpu")
    perturb_ba(tp, tl, 0.03, seed=seed)
    return (jp, jc, jl), (tp, tc, tl)


def _pm_to_std(w_pm, row_base, dr, dr_s):
    """The JAX package's p-major W ``[dl, dr_s·NRp, L]`` in the standard
    basis ``[dl, L, Dr]``, through ``pm_of_std`` built as its
    ``_w_pm_data`` builds it (``row_base`` per camera, Dr when fixed)."""
    nrp = -(-len(row_base) // 128) * 128
    sel = row_base < dr
    vids = np.nonzero(sel)[0]
    pm_of_std = np.empty(dr, dtype=np.int64)
    pm_of_std[row_base[sel][:, None] + np.arange(dr_s)] = np.arange(dr_s) * nrp + vids[:, None]
    return np.asarray(w_pm).transpose(0, 2, 1)[:, :, pm_of_std]


@pytest.mark.parametrize("n_fixed", [0, 2])
def test_fused_obs_leg_plain_matches_pallas(n_fixed):
    """B8's plain version against ``fused_obs_leg_pm`` in interpret mode,
    with dustbin pad slots and, with ``n_fixed``, the first cameras fixed:
    the JAX kernel sends them to its dustbin id, the port to its own."""
    rng = np.random.default_rng(n_fixed)
    n_cam, K, L, dr_s, dl, e_start = 7, 5, 37, 6, 3, 6
    jac = rng.standard_normal((2, dr_s + dl, K, L))
    g0 = rng.standard_normal((dr_s + dl, K, L))
    d1 = rng.random((K, L)) + 0.05
    d2 = -0.2 * rng.random((K, L))
    cam = rng.integers(0, n_cam, (K, L)).astype(np.int32)
    cam[1] = cam[0]  # a camera seen twice in a run
    pad = np.zeros((K, L), dtype=bool)
    pad[K - 1, ::3] = True
    d1[pad] = d2[pad] = 0.0
    jax_vc = np.where(pad | (cam < n_fixed), n_cam, cam).astype(np.int32)
    n_r = n_cam - n_fixed
    col_of = np.concatenate([np.full(n_fixed, n_r), np.arange(n_r), [n_r]]).astype(np.int32)
    h_j, g_j, w_pm = fused_obs_leg_pm(
        *(jnp.asarray(a) for a in (jac, g0, d1, d2, jax_vc)), n_cam, dr_s, dl, e_start,
        interpret=True,
    )
    h_t, g_t, w_t = fused_obs.fused_obs_leg(
        *(torch.as_tensor(a) for a in (jac, g0, d1, d2)),
        torch.as_tensor(col_of[jax_vc]), n_r, dr_s, dl, e_start,
    )
    assert w_t.shape == (L, dl, n_r * dr_s)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)
    row_base = np.where(np.arange(n_cam) < n_fixed, n_r * dr_s, (np.arange(n_cam) - n_fixed) * dr_s)
    np.testing.assert_allclose(
        w_t.permute(1, 0, 2).numpy(), _pm_to_std(w_pm, row_base, n_r * dr_s, dr_s), **TOL
    )


@pytest.mark.parametrize("fix2", [False, True])
def test_dual_route_system_matches_pallas(monkeypatch, fix2):
    """The port's whole dual-sorted system (B8's plain version, the
    camera repack and the camera-major leg) against the JAX package's
    ``NLLSTPU_W_IMPL=fused_interpret`` assembly, W through its basis
    gather; fixed cameras own no W columns and no reduced rows."""
    (jp, jc, jl), (tp, tc, tl) = _pair(5, 30, 2)
    monkeypatch.setenv("NLLSTPU_W_IMPL", "fused_interpret")
    jcomp = jax_compile(
        jp, jc[2:] + jl if fix2 else None, solver="schur", schur_family=nt.Euclidean(3)
    )
    assert jcomp.schur_info.w_pm is not None
    cost_j, sys_j = jax.jit(jcomp.assemble)(jp.stacked_variables())
    tcomp = pt.compile_problem(
        tp, tc[2:] + tl if fix2 else None, solver="schur",
        schur_family=pt.Euclidean(3), w_impl="fused",
    )
    fast = tcomp.schur_info.fast[0]
    assert fast.cam_batch is not None and fast.n_r == (3 if fix2 else 5)
    cost_t, sys_t = tcomp.assemble(tp.stacked_variables())
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-14)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    n_r, _, dr_s, pm_of_std = jcomp.schur_info.w_pm
    np.testing.assert_allclose(
        sys_t[4].permute(1, 0, 2).numpy(),
        np.asarray(sys_j[4]).transpose(0, 2, 1)[:, :, pm_of_std], **TOL,
    )
    lam = 1e-3
    x_j = np.asarray(jcomp.schur_info.ops().solve(sys_j, jnp.asarray(lam)))
    x_t = tcomp.ctx().linops.solve(sys_t, lam).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-9, atol=1e-12)


def test_reduce_s_lm_plain_matches_pallas():
    """B4's plain version against ``reduce_s_lm`` in interpret mode; the
    JAX kernel takes W landmark-minor ``[dl, wc, L]``, the port
    landmark-major ``[L, dl, wc]``."""
    rng = np.random.default_rng(17)
    dl, L, wc = 3, 300, 23
    w = rng.standard_normal((dl, wc, L))
    a = rng.standard_normal((dl, dl, L))
    h_inv = np.einsum("del,fel->dfl", a, a)
    g_l = rng.standard_normal((dl, L))
    s_j, r_j = jax_reduce_s_lm(*(jnp.asarray(x) for x in (w, h_inv, g_l)), interpret=True)
    s_t, r_t = schur_reduce.reduce_s_lm(
        torch.as_tensor(w.transpose(2, 0, 1).copy()), torch.as_tensor(h_inv), torch.as_tensor(g_l),
    )
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-12)


def _gauge_fixed_pair(problem):
    """``(jax problem, its unfixed and eliminated family), (torch problem,
    its unfixed, cameras and eliminated family)`` of a gauge-fixed test
    problem, the first two cameras fixed: the uniform 6/40 pinhole
    problem, or a Snavely BAL problem whose skewed tracks give four degree
    buckets (one B2 call over them)."""
    if problem == "pinhole":
        (jp, jc, jl), (tp, tc, tl) = _pair(6, 40, 9)
        return (jp, jc[2:] + jl, nt.Euclidean(3)), (tp, tc[2:] + tl, tc, pt.Euclidean(3))
    args = dict(ncameras=12, npoints=160, seed=3, noise=1e-3)
    jp, jc, jl = jbal.make_bal_problem(jbal.make_realistic_bal(**args), dtype=jnp.float64)
    jax_perturb_ba(jp, jl, 0.05, seed=5)
    tp, tc, tl = tbal.make_bal_problem(
        tbal.make_realistic_bal(**args), dtype=torch.float64, device="cpu"
    )
    perturb_ba(tp, tl, 0.05, seed=5)
    return (jp, jc[2:] + jl, jbal.PT), (tp, tc[2:] + tl, tc, tbal.PT)


@functools.cache
def _gauge_fixed_jax(problem):
    """The JAX package's LM on a gauge-fixed test problem (its default
    assembly and solve), and its final variables."""
    (jp, j_unfixed, jfam), _ = _gauge_fixed_pair(problem)
    r = nt.optimize(
        jp, nt.Options(solver="schur", schur_family=jfam, rel_dcost=1e-6,
                       store_trajectory="jit"),
        unfixed=j_unfixed,
    )
    return r, {k: np.asarray(v) for k, v in jp.stacked_variables().items()}


@pytest.mark.parametrize("problem,w_impl", [
    pytest.param("pinhole", "fused", id="fused"),
    pytest.param("pinhole", "fused_all", id="fused_all"),
    pytest.param("bal", "fused_all", id="bal-buckets-fused_all"),
])
def test_gauge_fixed_lm_trace_matches_jax(problem, w_impl):
    """LM with the first two cameras fixed (BA's gauge removed), through
    either assembly route (B8 and the camera-major leg; B1 on the uniform
    pinhole layout, B2 over the degree buckets of the BAL one) and the float64
    solve over external inverses: the JAX package's iteration count and
    cost trace to 1e-10, and its final variables; the fixed cameras do not
    move.  Both runs stop before the float64 rounding floor
    (``rel_dcost=1e-6``), where a damping trial is accepted or rejected by
    rounding alone."""
    r_j, final_j = _gauge_fixed_jax(problem)
    _, (tp, t_unfixed, tc, fam) = _gauge_fixed_pair(problem)
    comp = pt.compile_problem(tp, t_unfixed, solver="schur", schur_family=fam, w_impl=w_impl)
    (fast,) = comp.schur_info.fast
    assert fast.n_r == len(tc) - 2
    assert len(fast.buckets) == (4 if problem == "bal" else 1)
    cams0 = tp.stacked_variables()[tc[0].family][:2].clone()
    r_t = pt.optimize(
        tp, pt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6),
        unfixed=t_unfixed, w_impl=w_impl,
    )
    assert r_t.num_iterations == r_j.num_iterations
    assert r_t.linear_solves == r_j.linear_solves
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-10)
    np.testing.assert_allclose(r_t.best_cost, r_j.best_cost, rtol=1e-10)
    final_t = tp.stacked_variables()
    assert torch.equal(final_t[tc[0].family][:2], cams0)
    for name, v in final_t.items():
        np.testing.assert_allclose(v.numpy(), final_j[name], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("form", ["none", "manifold", "handle", "handles", "masks"])
def test_resolve_unfixed_forms(form):
    """Every form of ``unfixed`` gives the JAX package's masks and
    layout, the eliminated family last (a fixed variable's offset is
    ``dof_total``)."""
    (jp, jc, jl), (tp, tc, tl) = _pair(4, 12, 1)

    def spec(cams, lmks, man):
        return {
            "none": None,
            "manifold": man,
            "handle": cams[1],
            "handles": cams[2:] + lmks[::2],
            "masks": {cams[0].family: np.arange(4) % 2 == 1},
        }[form]

    masks_j = jax_engine.resolve_unfixed(jp, spec(jc, jl, nt.Euclidean(3)))
    masks_t = engine.resolve_unfixed(tp, spec(tc, tl, pt.Euclidean(3)))
    assert masks_j.keys() == masks_t.keys()
    for name in masks_j:
        assert np.array_equal(masks_t[name], masks_j[name]), name
    last = pt.family_name(pt.Euclidean(3))
    lay_j = jax_engine.build_layout(jp, spec(jc, jl, nt.Euclidean(3)), order_last=last)
    lay_t = engine.build_layout(tp, spec(tc, tl, pt.Euclidean(3)), order_last=last)
    assert lay_t.dof_total == lay_j.dof_total and lay_t.pad == lay_j.pad
    for name in lay_j.offsets:
        assert np.array_equal(lay_t.offsets[name], np.asarray(lay_j.offsets[name])), name


def test_refusals(monkeypatch):
    """What the slice does not take raises and says why: the dual-sorted
    route on a degree-bucketed batch, on a camera repack past its skew
    limits and on the implicit backend, an unknown route, and nothing to
    optimize.  Nothing falls back."""
    _, (tp, tc, tl) = _pair(4, 16, 1)
    euc = pt.Euclidean(3)
    bp, _, _ = tbal.make_bal_problem(
        tbal.make_realistic_bal(12, 160, seed=3, noise=1e-3), dtype=torch.float64, device="cpu"
    )
    with pytest.raises(NotImplementedError, match="degree buckets"):
        pt.compile_problem(bp, solver="schur", schur_family=tbal.PT, w_impl="fused")
    with pytest.raises(NotImplementedError, match="implicit backend"):
        pt.compile_problem(tp, solver="schur_cg", schur_family=euc, w_impl="fused")
    with pytest.raises(ValueError, match="w_impl"):
        pt.compile_problem(tp, solver="schur", schur_family=euc, w_impl="onehot")
    with pytest.raises(ValueError, match="no unfixed variables"):
        pt.optimize(tp, pt.Options(schur_family=euc), unfixed=[])
    monkeypatch.setattr(schur, "_FAST_MAX_CAM_K", 1)
    with pytest.raises(NotImplementedError, match="skew limits"):
        pt.compile_problem(tp, solver="schur", schur_family=euc, w_impl="fused")


@pytest.mark.parametrize("dtype,route", [
    pytest.param(torch.float32, "reduce", id="dtype0-reduce"),
    pytest.param(torch.float64, "reduce_lm", id="dtype1-reduce_lm"),
])
def test_solve_routes_by_dtype(dtype, route):
    """An obs-major W goes to B3 in float32 and to B4 (``reduce_lm``),
    over inverses formed in float64, otherwise; B5's route over W's own
    structure (``schur.w_structure``) gives the same step, each route
    through its plain version."""
    tp, tc, tl = make_pinhole_ba(5, 30, 0.7, noise=1e-3, dtype=dtype, batched="cm", device="cpu")
    perturb_ba(tp, tl, 0.03, seed=2)
    comp = pt.compile_problem(tp, tc[1:] + tl, solver="schur", schur_family=pt.Euclidean(3),
                              w_impl="fused")
    calls = []

    def counted(name):
        fn = getattr(comp.kernels, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    comp.kernels = dataclasses.replace(
        comp.kernels, **{n: counted(n) for n in ("reduce", "reduce_lm", "reduce_external")}
    )
    _, sys_ = comp.assemble(tp.stacked_variables())
    x = comp.ctx().linops.solve(sys_, 1e-2)
    assert calls == [route]
    assert comp.schur_info.w_rows is not None and comp.schur_info.w_pairs is None
    other = schur.SchurOps(comp.schur_info.dim_reduced, pairs=schur.w_structure(comp.schur_info))
    np.testing.assert_allclose(
        x.numpy(), other.solve(sys_, 1e-2).numpy(),
        rtol=1e-4 if dtype == torch.float32 else 1e-10, atol=1e-6,
    )
