"""The port's implicit Schur backend against the JAX package, on the CPU in
float64: kernel B6's plain version against the Pallas kernel (interpret
mode) and its reference, the assembled implicit system, the PCG solve
(against the JAX package's, with its default layout and with the Pallas
sorted-run reduction), the Levenberg-Marquardt trace, the implicit step
against the port's own direct step, and the automatic switch past the
dense-W byte limit; and the damped landmark inverse on blocks that are
singular in float32."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
import nllstpu.core.optimize as jax_optimize
import nllstpu.ops.schur as jax_schur
from nllstpu.models import bal as jbal
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.ops.pallas import segment_sum as jax_b6
import nllstpu_torch as pt
import nllstpu_torch.core.optimize as pt_optimize
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.core import linearsolver
from nllstpu_torch.ops import schur, segment_sum

#: ``make_realistic_bal`` arguments of the test problems (skewed tracks):
#: the assembly's, and a smaller one for the solves, whose float64 PCG
#: takes a few hundred iterations at tol 1e-12 on the larger.
SHAPE = dict(ncameras=12, npoints=300, seed=3, noise=1e-3, track_alpha=2.3)
SMALL = dict(SHAPE, ncameras=8, npoints=150)
HUBER = 5.0


def _pair(robust_width=HUBER, shape=SHAPE):
    jp, _, jpts = jbal.make_bal_problem(
        jbal.make_realistic_bal(**shape), dtype=jnp.float64, robust_width=robust_width,
    )
    jax_perturb_ba(jp, jpts, 0.05, seed=5)
    tp, _, tpts = tbal.make_bal_problem(
        tbal.make_realistic_bal(**shape), dtype=torch.float64, device="cpu",
        robust_width=robust_width,
    )
    perturb_ba(tp, tpts, 0.05, seed=5)
    return jp, tp


def _runs(rng, nseg):
    """Skewed run lengths with empty runs and one of 2·CHUNK + 17 rows."""
    lengths = rng.geometric(0.08, nseg)
    lengths[[2, 5]] = 0
    lengths[7] = 2 * jax_b6.CHUNK + 17
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [3, 12])
def test_segment_block_sum_matches_pallas(d, dtype):
    """B6's plain version against the Pallas kernel in interpret mode and
    its reference: float64 within 1e-12, float32 within 1e-5 of the
    largest entry (sums of up to 529 rows in another order)."""
    rng = np.random.default_rng(d)
    starts = _runs(rng, 20)
    n = int(starts[-1])
    data = np.zeros((n + jax_b6.CHUNK, d), dtype=dtype)  # the TPU's DMA pad
    data[:n] = rng.standard_normal((n, d))
    expect = np.stack([data[a:b].astype(np.float64).sum(0) for a, b in zip(starts[:-1], starts[1:])])
    tol = (1e-12 if dtype == np.float64 else 1e-5) * np.abs(expect).max()
    pallas = np.asarray(jax_b6.segment_block_sum(jnp.asarray(data), jnp.asarray(starts), interpret=True))
    ref = np.asarray(jax_b6.segment_block_sum_reference(jnp.asarray(data), jnp.asarray(starts)))
    for st in (starts, starts.astype(np.int64)):
        # Rows past starts[-1] are ignored: with or without the pad rows.
        for rows in (data, data[:n]):
            got = segment_sum.segment_block_sum(torch.from_numpy(rows), torch.from_numpy(st))
            assert got.dtype == torch.from_numpy(data).dtype and got.shape == (20, d)
            for other in (pallas, ref, expect):
                np.testing.assert_allclose(got.numpy(), other, rtol=0, atol=tol)
    assert not pallas[2].any() and not pallas[5].any()


def test_implicit_assembly_matches_jax():
    """cost, a_rr, b_r, h_ll and g_l (every sum through B6's plain
    version) against the JAX package's ``solver="schur_cg"`` assembly,
    Huber kernel, within 1e-10 relative."""
    jp, tp = _pair()
    jc = jax_optimize.compile_problem(jp, solver="schur_cg", schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver="schur_cg", schur_family=tbal.PT)
    assert jc.schur_info.implicit and tc.schur_info.implicit
    for name, off in tc.layout.offsets.items():
        assert np.array_equal(off, np.asarray(jc.layout.offsets[name])), name
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max())
    (wp,) = sys_t[4]
    assert wp.w_blk.shape == (tp.batches()[0].mask.shape[0], 9, 3)
    # Landmark runs are sorted and complete; camera runs cover every cost.
    n = tp.batches()[0].n
    assert int(wp.lstarts[-1]) == n and int(wp.cstarts[-1]) == n == wp.cperm.shape[0]
    assert bool((wp.lid[:n] == torch.repeat_interleave(
        torch.arange(wp.lstarts.shape[0] - 1), torch.diff(wp.lstarts.long()))).all())


def _by_variable(x, layout, manifolds):
    """Flat step → per family ``[n, dof]`` in variable order (the two
    packages may relabel landmarks differently)."""
    x = np.asarray(x)
    return {
        name: x[np.asarray(off)[:, None] + np.arange(manifolds[name].dof)]
        for name, off in layout.offsets.items()
    }


@pytest.mark.parametrize("pallas", [False, True], ids=["default", "pallas_b6"])
def test_implicit_solve_matches_jax(pallas, monkeypatch):
    """The PCG solve at tol 1e-12 against the JAX package's, within 1e-8
    of max|x|, at λ ∈ {1e-3, 1e-1}.  ``pallas_b6``: the JAX repack is
    switched off so that its Wᵀv goes through the Pallas B6 kernel in
    interpret mode (as tests/test_pallas.py does)."""
    if pallas:
        monkeypatch.setattr(jax_schur, "_OBS_MAJOR_MAX_RATIO", 0.0)
        monkeypatch.setenv("NLLSTPU_SEGMENT_IMPL", "pallas_interpret")
    jp, tp = _pair(shape=SMALL)
    jc = jax_optimize.compile_problem(jp, solver="schur_cg", schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver="schur_cg", schur_family=tbal.PT)
    _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    _, sys_t = tc.assemble(tp.stacked_variables())
    ops_j = dataclasses.replace(jc.schur_info.ops(), tol=1e-12)
    if pallas:
        assert ops_j.segment_impl == "pallas_interpret" and sys_j[4][0].starts is not None
    ops_t = tc.ctx(pt.Options(linear_tol=1e-12)).linops
    mans = {n: tp.manifold_of(n) for n in tp.family_names()}
    for lam in (1e-3, 1e-1):
        x_j = _by_variable(ops_j.solve(sys_j, jnp.asarray(lam)), jc.layout, mans)
        x_t = _by_variable(ops_t.solve(sys_t, lam), tc.layout, mans)
        scale = max(np.abs(v).max() for v in x_j.values())
        for name in x_j:
            np.testing.assert_allclose(x_t[name], x_j[name], rtol=0, atol=1e-8 * scale, err_msg=name)
    assert len(ops_t.cg_iters) == 2 and all(0 < k < schur.CG_MAX_ITERS for k in ops_t.cg_iters)


def test_implicit_lm_trace_matches_jax():
    """LM through the implicit backend: same iterations, solves and
    termination as the JAX package, costs within 1e-9 relative."""
    jp, tp = _pair(shape=SMALL)
    r_j = nt.optimize(jp, nt.Options(
        solver="schur_cg", schur_family=jbal.PT, rel_dcost=1e-6, store_trajectory="jit",
    ))
    r_t = pt.optimize(tp, pt.Options(
        solver="schur_cg", schur_family=tbal.PT, rel_dcost=1e-6, max_time=float("inf"),
    ))
    assert r_t.num_iterations == r_j.num_iterations
    assert r_t.linear_solves == r_j.linear_solves
    assert r_t.termination == r_j.termination
    np.testing.assert_allclose(r_t.start_cost, r_j.start_cost, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, np.asarray(r_j.trajectory.costs), rtol=1e-9)
    assert r_t.best_cost < 1e-3 * r_t.start_cost


@pytest.mark.parametrize("lam", [1e-1, 1.0])
def test_implicit_step_matches_direct_step(lam):
    """The port's implicit step (tol 1e-12) against its own direct step on
    the same problem, within 1e-8 of max|x|: both compiles share the
    layout, and the assembled a_rr, b_r, h_ll, g_l agree."""
    _, tp = _pair(shape=SMALL)
    ti = pt.compile_problem(tp, solver="schur_cg", schur_family=tbal.PT)
    td = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    assert ti.schur_info.implicit and not td.schur_info.implicit
    v = tp.stacked_variables()
    _, sys_i = ti.assemble(v)
    _, sys_d = td.assemble(v)
    for a, b in zip(sys_i[:4], sys_d[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12 * b.abs().max().item())
    x_i = ti.ctx(pt.Options(linear_tol=1e-12)).linops.solve(sys_i, lam)
    x_d = td.ctx().linops.solve(sys_d, lam)
    np.testing.assert_allclose(x_i.numpy(), x_d.numpy(), rtol=0, atol=1e-8 * x_d.abs().max().item())


def test_dense_w_limit_switches_like_jax(monkeypatch):
    """Both packages pick the same backend at the dense-W byte limit: the
    JAX formula counts the layout's pad columns, n_elim·(Dr + pad)·dl·
    itemsize.  Between the formula without pad and the one with it, the
    port used to stay direct where the JAX package switches."""
    jp, tp = _pair(shape=SMALL)
    L, dl = 150, 3
    dr, pad = 8 * 9, 12
    old, new = L * dr * dl * 8, L * (dr + pad) * dl * 8
    for limit, implicit in ((old, True), (new - 1, True), (new, False)):
        monkeypatch.setattr(jax_optimize, "DENSE_W_BYTE_LIMIT", limit)
        monkeypatch.setattr(pt_optimize, "DENSE_W_BYTE_LIMIT", limit)
        jc = jax_optimize.compile_problem(jp, solver="schur", schur_family=jbal.PT)
        tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
        assert tc.layout.pad == pad and tc.schur_info.dim_reduced == dr
        assert jc.schur_info.implicit == tc.schur_info.implicit == implicit, limit
    # Past the limit, optimize runs the implicit backend instead of raising.
    monkeypatch.setattr(pt_optimize, "DENSE_W_BYTE_LIMIT", old)
    r = pt.optimize(tp, pt.Options(schur_family=tbal.PT, max_iters=2, linear_tol=1e-2))
    assert r.num_iterations == 2 and r.best_cost < r.start_cost


def test_damped_inverse_survives_blocks_singular_in_float32():
    """Landmark blocks of the float32 Dubrovnik-class problem at its eighth
    LM iteration (eigenvalues ~1e4, ~1e4 and ~1e-4, λ ≈ 3e-4): the float32
    closed form divides by a determinant that rounds to zero, and the NaN
    step ended the run.  The implicit solve forms the inverse in float64:
    finite, and the inverse of the float32 block to float32 rounding."""
    h = torch.tensor([
        [[8205.9805, -23.8038, -4903.8398], [-23.8038, 8034.9336, -652.9429],
         [-4903.8398, -652.9429, 2985.8999]],
        [[8957.2930, -31.5431, -5000.1865], [-31.5431, 8787.3984, -317.6909],
         [-5000.1865, -317.6909, 2804.0242]],
    ], dtype=torch.float32).permute(1, 2, 0)
    lam = 3.0097938724793494e-4
    eye = torch.eye(3)[:, :, None]
    assert not torch.isfinite(linearsolver.batched_inv_spd_cm(h + lam * eye)).all()
    got = schur.SchurCGOps.damped_inverse(h, lam)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    exact = torch.linalg.inv((h.double() + lam * eye.double()).permute(2, 0, 1)).permute(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-6, atol=1e-6 * exact.abs().max().item())
