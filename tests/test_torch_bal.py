"""The port's Snavely BAL path against the JAX package, on the CPU in
float64: the generators, the BAL text format, the Snavely residual and its
hand Jacobian, and the degree-bucketed direct-Schur slice (kernel B2's
plain version, then B3's) — the assembled system, the damped solve and the
Levenberg-Marquardt cost trace (held to 1e-9 relative)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
import nllstpu_torch as pt
from nllstpu_torch.core import linearsolver
from nllstpu_torch.core.optimize import run_loop
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.ops import schur, schur_reduce

#: ``make_realistic_bal`` arguments of the two test shapes: four degree
#: classes; and seven buckets led by a chunk bucket over the heavy prefix,
#: which the next bucket covers again.
SHAPES = {
    "4 buckets": ((12, 160), dict(seed=3, noise=1e-3)),
    "chunk bucket": ((80, 160), dict(seed=3, noise=1e-3, track_alpha=1.0, max_track=80)),
}


def _pair(shape, robust_width=None):
    args, kw = SHAPES[shape]
    jp, _, jpts = jbal.make_bal_problem(
        jbal.make_realistic_bal(*args, **kw), dtype=jnp.float64,
        robust_width=robust_width,
    )
    jax_perturb_ba(jp, jpts, 0.05, seed=5)
    tp, _, tpts = tbal.make_bal_problem(
        tbal.make_realistic_bal(*args, **kw), dtype=torch.float64,
        device="cpu", robust_width=robust_width,
    )
    perturb_ba(tp, tpts, 0.05, seed=5)
    return jp, tp


@pytest.mark.parametrize("gen,args", [
    ("make_synthetic_bal", dict(ncameras=16, npoints=64, obs_per_point=4, seed=2, noise=1e-3)),
    ("make_realistic_bal", dict(zip(("ncameras", "npoints"), SHAPES["4 buckets"][0]),
                                **SHAPES["4 buckets"][1])),
    ("make_realistic_bal", dict(zip(("ncameras", "npoints"), SHAPES["chunk bucket"][0]),
                                **SHAPES["chunk bucket"][1])),
])
def test_bal_generators_identical(gen, args):
    dj = getattr(jbal, gen)(**args)
    dt = getattr(tbal, gen)(**args)
    assert dj.keys() == dt.keys()
    for k in dj:
        assert dj[k].dtype == dt[k].dtype and np.array_equal(dj[k], dt[k]), k


def test_bal_text_round_trip(tmp_path):
    data = tbal.make_realistic_bal(7, 20, seed=4, noise=1e-3)
    tbal.write_bal(tmp_path / "port.txt", data)
    jbal.write_bal(tmp_path / "jax.txt", data)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    back = tbal.load_bal(str(tmp_path / "port.txt"))
    for k in data:
        assert np.array_equal(back[k], data[k]), k
    assert back["cam_idx"].dtype == np.int32 and back["pt_idx"].dtype == np.int32


def _snavely_inputs(n=40, seed=0):
    """Cameras and points of the generators' geometry, with the rotation of
    the first cameras exactly zero or inside the small-angle series."""
    rng = np.random.default_rng(seed)
    data = tbal.make_realistic_bal(8, n, seed=seed, noise=1e-3)
    cam = data["cameras"][data["cam_idx"][:n]].copy()
    cam[:, 7:9] = rng.standard_normal((n, 2)) * 1e-3  # visible distortion
    cam[0, :3] = 0.0
    cam[1, :3] = [3e-8, -2e-8, 1e-8]  # θ² = 1.4e-15 < 1e-14
    cam[2, :3] = [2e-7, 0.0, 0.0]  # θ² = 4e-14: the closed form
    pts = data["points"][data["pt_idx"][:n]]
    meas = data["observations"][:n]
    return meas, cam.T.copy(), pts.T.copy()


def test_snavely_residual_and_jacobian_match_jax():
    meas, cam, pts = _snavely_inputs()
    r_j = np.asarray(jbal.snavely_residual_cm(*(jnp.asarray(x) for x in (meas, cam, pts))))
    rr_j, jac_j = (np.asarray(x) for x in jbal.snavely_jacobian_cm(
        *(jnp.asarray(x) for x in (meas, cam, pts))
    ))
    t_in = [torch.from_numpy(x) for x in (meas, cam, pts)]
    r_t = tbal.snavely_residual_cm(*t_in).numpy()
    rr_t, jac_t = (x.numpy() for x in tbal.snavely_jacobian_cm(*t_in))
    assert jac_t.shape == (2, 12, meas.shape[0])
    for got, ref in ((r_t, r_j), (rr_t, rr_j), (rr_t, r_t)):
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(jac_t, jac_j, rtol=1e-12, atol=1e-12 * np.abs(jac_j).max())
    # The w = 0 column is the series' limit: the rotation block is X×q.
    assert np.isfinite(jac_t[:, :, :3]).all()


def test_make_bal_problem_rejects_unported_forms():
    data = tbal.make_synthetic_bal(4, 8)
    # Adaptive kernels are ported: the JAX package's kernel object is not
    # one, and the port's needs its parameters.
    with pytest.raises(TypeError, match="not a robust kernel of the port"):
        tbal.make_bal_problem(data, device="cpu", kernel=nt.ContaminatedGaussian(),
                              kernel_params=np.ones(3))
    with pytest.raises(ValueError, match="kernel_params"):
        tbal.make_bal_problem(data, device="cpu", kernel=pt.ContaminatedGaussian())
    p, _, _ = tbal.make_bal_problem(data, device="cpu", robust_width=2.0)
    (b,) = p.batches()
    assert b.kernel == pt.Huber(2.0) and b.jacobian is tbal.snavely_jacobian_cm


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bucketed_assembly_and_solve_match_jax(shape):
    """The degree-bucketed system (one B2 plain-version call over every
    bucket) and the damped solve against the JAX package's one-hot assembly."""
    jp, tp = _pair(shape)
    jc = jax_compile(jp, solver="schur", schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    (meta_j,) = jc.obs_meta
    (fast,) = tc.schur_info.fast
    assert fast.buckets == meta_j.buckets
    if shape == "chunk bucket":
        counts = np.sort(np.bincount(jp.batches()[0].idx[1][: jp.batches()[0].n]))[::-1]
        assert (0, 7, 16, 64) in schur._plan_obs_buckets(counts)
        assert len(fast.buckets) == 7 and fast.buckets[:2] == ((0, 7, 16, 0), (0, 32, 64, 112))
    else:
        assert len(fast.buckets) == 4
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, rtol=1e-10,
                                   atol=1e-12 * np.abs(b).max())
    w_j = np.asarray(sys_j[4]).transpose(1, 0, 2)
    np.testing.assert_allclose(sys_t[4].numpy(), w_j, rtol=1e-10, atol=1e-12 * np.abs(w_j).max())
    # Both solves on the JAX package's system.  S spans seven decades on its
    # diagonal (focal length against rotation) and has BA's gauge freedom:
    # at λ = 1e-3 its condition number is ~2.4e10, so two correct float64
    # solves may differ by κ·ε ≈ 5e-6 of the reduced step, and which of
    # them lands nearer depends on the host's rounding.  Each step is held
    # instead to an exact solve of S formed here in float64 (three rounds
    # of refinement over long-double residuals): its backward error within
    # 4·φ·ε, φ = ‖A_rr + Σ|W||H⁻¹||W|ᵀ‖/‖S‖ the cancellation in forming S
    # (1.5e3 at λ = 1e-3 on the chunk-bucket shape, ~33 on 4 buckets;
    # measured 76ε and 0.4ε), and its forward error within 16·κ·ε (measured
    # 0.48·κ·ε); the JAX package's step meets both too.  At λ = 1 the two
    # solves still agree within 1e-10 of the largest entry (measured 4e-11).
    sys_jt = [torch.tensor(np.asarray(x)) for x in sys_j]
    sys_jt[4] = sys_jt[4].permute(1, 0, 2).contiguous()
    a_rr, b_r, h_ll, g_l, w = (t.numpy() for t in sys_jt)
    dr = a_rr.shape[0]
    eps = np.finfo(np.float64).eps
    for lam in (1e-3, 1.0):
        x_j = np.asarray(jc.schur_info.ops().solve(sys_j, jnp.asarray(lam)))
        x_t = tc.ctx().linops.solve(tuple(sys_jt), lam).numpy()
        h_inv = np.linalg.inv(h_ll.transpose(2, 0, 1) + lam * np.eye(3))
        s_mat = a_rr + lam * np.eye(dr) - np.einsum("lda,lde,leb->ab", w, h_inv, w)
        rhs = b_r - np.einsum("lda,lde,el->a", w, h_inv, g_l)
        phi = np.linalg.norm(
            np.abs(a_rr) + lam * np.eye(dr)
            + np.einsum("lda,lde,leb->ab", np.abs(w), np.abs(h_inv), np.abs(w)), 2,
        ) / np.linalg.norm(s_mat, 2)
        ev = np.linalg.eigvalsh(s_mat)
        kappa = ev[-1] / ev[0]
        ref = _refined_solve(s_mat, rhs)
        norm_s = np.linalg.norm(s_mat, 2)
        errs = {}
        for who, x in (("port", x_t[:dr]), ("jax", x_j[:dr])):
            bwd = np.linalg.norm(s_mat @ x - rhs) / (norm_s * np.linalg.norm(x) + np.linalg.norm(rhs))
            fwd = np.abs(x - ref).max() / np.abs(ref).max()
            errs[who] = (bwd / eps, fwd / (kappa * eps))
        msg = (f"λ={lam}: κ(S)={kappa:.3e}, φ={phi:.1f}; backward error / ε and forward "
               f"error / (κ·ε): {errs}")
        for who, (bwd, fwd) in errs.items():
            assert bwd <= 4 * phi and fwd <= 16, f"{who} step: {msg}"
        if lam == 1.0:
            np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-10 * np.abs(x_j).max(),
                                       err_msg=msg)


def _refined_solve(a, b, rounds=3):
    """``a⁻¹ b`` in float64, refined over residuals taken in long double."""
    x = np.linalg.solve(a, b)
    al, bl = a.astype(np.longdouble), b.astype(np.longdouble)
    for _ in range(rounds):
        x = x + np.linalg.solve(a, (bl - al @ x.astype(np.longdouble)).astype(np.float64))
    return x


@pytest.mark.parametrize("robust_width", [None, 5.0])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bucketed_lm_trace_matches_jax(shape, robust_width):
    """LM on the bucketed layout: same iterations, linear solves and
    termination, a cost trace within 1e-9 relative.  ``rel_dcost`` ends
    both runs before the float64 rounding floor, where a step that changes
    the cost by 1e-16 relative is accepted or rejected by rounding alone.
    The JAX package moves from itself by at most 2.1e-10 of its trace when
    its start is scaled by 1 ± 2⁻⁵² (iterations, solves and termination
    unchanged; ``scripts_torch/trace_spread.py bal``), so 1e-9 is out of
    rounding's reach.  ``max_time`` is lifted: the default 30 s budget
    ended the port's run early under a loaded parallel test run."""
    jp, tp = _pair(shape, robust_width)
    r_j = nt.optimize(jp, nt.Options(
        solver="schur", schur_family=jbal.PT, rel_dcost=1e-6,
        store_trajectory="jit",
    ))
    r_t = pt.optimize(tp, pt.Options(solver="schur", schur_family=tbal.PT, rel_dcost=1e-6,
                                     max_time=float("inf")))
    counts = [(r.num_iterations, r.linear_solves, r.termination, r.time_total) for r in (r_t, r_j)]
    msg = f"(iterations, solves, termination, seconds) port, jax: {counts}"
    assert counts[0][:3] == counts[1][:3], msg
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12, err_msg=msg)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9,
                               err_msg=msg)
    assert r_t.best_cost < 1e-3 * r_t.start_cost


def _scaled_backward_error(s, rhs, x):
    """The normwise backward error, in float64, of ``x`` as a solution of
    the equilibrated system (D S D) y = D rhs, y = D⁻¹ x, D = |diag S|^-½:
    ‖D(rhs − S x)‖∞ / (‖D S D‖∞ ‖D⁻¹ x‖∞ + ‖D rhs‖∞), the system that
    ``linearsolver.cholesky_solve`` solves for a float32 S."""
    s, rhs, x = s.double(), rhs.double(), x.double()
    d = torch.diagonal(s).abs().rsqrt()
    res = d * (rhs - s @ x)
    sd = d[:, None] * s * d[None, :]
    return float(res.abs().max() / (sd.abs().sum(1).max() * (x / d).abs().max()
                                    + (d * rhs).abs().max()))


def test_float32_reduced_solve_is_equilibrated():
    """After three float64 LM iterations on the chunk-bucket shape, the
    float32 reduced system is indefinite by rounding; the port's solve
    (scaled to a unit diagonal) matches an exact solve of that float32
    system to a few percent, where unscaled LU is off by ~20 times the
    step.  The system is formed over float32 closed-form inverses, as the
    JAX package forms them.  The port's own float32 solve (B3's plain
    version forms the inverses in float64, which leaves this state's
    scaled system singular to float32, so an exact solve of it is no
    yardstick) is held to the float64 solve of the float64 system: the
    same LM trial (the cost change of its step within 5% of the float64
    step's, same sign) and the step within 0.2 of the float64 step's
    largest entry.  On this singular state both packages' float32 steps
    move with the host's BLAS: the port's cost change measured 1.80% off
    the float64 step's and the JAX package's 0.85% on one host, where an
    earlier host gave 0.08% and 4.6% (``scripts_torch/reduced_f32_step.py``),
    so the two are not compared.  What holds on every host is the solve
    itself: the reduced part of the port's step has a backward error, as a
    solution of the equilibrated system the port solves, within √n·ε of
    float32 (measured 0.17 ε at n = 720), the size that rounding reaches
    in practice; unscaled LU of the same float32 system, which is
    backward stable only in the unscaled norm, fails that bound
    (measured 445 ε)."""
    args, kw = SHAPES["chunk bucket"]
    tp, _, tpts = tbal.make_bal_problem(tbal.make_realistic_bal(*args, **kw),
                                        dtype=torch.float64, device="cpu")
    perturb_ba(tp, tpts, 0.05, seed=5)
    tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    st = run_loop(tc.assemble, tc.cost, tc.ctx(), pt.Options(
        schur_family=tbal.PT, max_iters=3, rel_dcost=0.0, abs_dcost=0.0,
    ), tp.stacked_variables())
    lam = float(st["itdata"]["lm_lambda"])
    a_rr, b_r, h_ll, g_l, w = (t.float() for t in tc.assemble(st["variables"])[1])
    h_inv = linearsolver.batched_inv_spd_cm(h_ll + lam * torch.eye(3)[:, :, None])
    s_sum, rhs_sum = schur_reduce.reduce_s_reference(w, h_inv, g_l)
    s = a_rr + lam * torch.eye(a_rr.shape[0]) - s_sum
    rhs = b_r - rhs_sum
    assert int(torch.linalg.cholesky_ex(s)[1]) > 0
    exact = np.linalg.solve(s.double().numpy(), rhs.double().numpy())
    got = linearsolver.cholesky_solve(s, rhs)
    assert got.dtype == torch.float32
    assert np.abs(got.double().numpy() - exact).max() <= 0.1 * np.abs(exact).max()
    v = st["variables"]
    cost0, sys64 = tc.assemble(v)
    ops = tc.ctx().linops
    x64 = ops.solve(sys64, lam)
    sys32 = tuple(t.float() for t in sys64)
    x32 = ops.solve(sys32, lam)
    assert x32.dtype == torch.float32
    d64, d32 = (float(tc.cost(tc.apply(v, x.double())) - cost0) for x in (x64, x32))
    assert d32 * d64 > 0 and abs(d32 - d64) <= 0.05 * abs(d64)
    assert float((x32.double() - x64).abs().max()) <= 0.2 * float(x64.abs().max())
    s32, rhs32, _ = ops.reduced(sys32, lam)
    xr = linearsolver.cholesky_solve(s32, rhs32)
    n = s32.shape[0]
    assert torch.equal(x32[:n], xr)  # the step's reduced part is this solve
    bound = n ** 0.5 * torch.finfo(torch.float32).eps
    eta = _scaled_backward_error(s32, rhs32, xr)
    assert eta <= bound, (eta, bound)
    # A wrong solve fails the criterion: unscaled LU of the float32 system.
    eta_lu = _scaled_backward_error(s32, rhs32, torch.linalg.solve(s32, rhs32))
    assert eta_lu > bound, (eta_lu, bound)
