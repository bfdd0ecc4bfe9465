"""The direct Schur solve at landmark blocks past the unrolled dl ≤ 6, on
the CPU: kernel B5's plain versions at dl = 18 against the JAX package's
interpret-mode Pallas ``reduce_s``, and trajectory-space NRSfM
(``scripts_torch/anydl_reference.py``: K DCT coefficients per axis, dl =
3K) against the JAX package's direct solve — through the obs-major route
(B1/B2 at (2, 6, 3K), the damped inverses, B4), whose system equals the
generic route's, and in its adaptive form through the generic route (B6
keyed sums, B7, B5).

Tolerances: the reduction to rtol 1e-12 of the largest entry (the same
float64 products, summed in another order); the LM traces to 1e-9
relative with the same iterations, solves and termination, as the port's
other float64 trace tests, stopping at ``rel_dcost=1e-6`` before the
float64 floor; the hand Jacobian to 1e-12 of the largest entry against
``auto_cm_jacobian``'s forward mode."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nllstpu as nt
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.ops.pallas.schur_reduce import reduce_s as jax_reduce_s
import nllstpu_torch as pt
from nllstpu_torch.core.problem import auto_cm_jacobian
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.ops import fused_obs, schur, schur_reduce
from scripts_torch import anydl_reference as ar

#: The small NRSfM problem of the trace tests: 12 frames, 96 points.
SMALL = dict(nframes=12, npoints=96, vis=0.8)


def _structured(rng, L, dl, widths):
    """A W [L, dl, wc] zero outside blocks of ``widths`` (landmark l holding
    a random subset, every 7th none), SPD inverses, g_l, and the structure's
    tables."""
    bcol = np.concatenate([[0], np.cumsum(widths)[:-1]])
    held = rng.random((L, len(widths))) < 0.5
    held[::7] = False
    lmk, blk = np.nonzero(held)
    w = np.zeros((L, dl, int(np.sum(widths))))
    for l, b in zip(lmk, blk):
        w[l, :, bcol[b] : bcol[b] + widths[b]] = rng.standard_normal((dl, widths[b]))
    a = rng.standard_normal((L, dl, dl))
    h_inv = np.linalg.inv(a @ a.transpose(0, 2, 1) + 2.0 * np.eye(dl)).transpose(1, 2, 0)
    tables = schur_reduce.row_tables(lmk, blk, L, bcol, widths)
    return w, np.ascontiguousarray(h_inv), rng.standard_normal((dl, L)), tables


def test_plain_reduction_matches_pallas_at_dl18():
    """Both plain versions of B5 (the dense one the CPU path takes and the
    structured mirror of the kernel's order) at dl = 18 over mixed block
    widths, against the JAX package's ``reduce_s`` in interpret mode on the
    same numpy inputs (its W components-major, [dl, L, wc])."""
    w, h_inv, g_l, tables = _structured(np.random.default_rng(18), 40, 18, [6, 9, 1, 16, 3, 6])
    s_j, r_j = jax_reduce_s(jnp.asarray(w.transpose(1, 0, 2)), jnp.asarray(h_inv),
                            jnp.asarray(g_l), interpret=True)
    s_j, r_j = np.asarray(s_j), np.asarray(r_j)
    args = [torch.as_tensor(x) for x in (w, h_inv, g_l)]
    for s_t, r_t in (schur_reduce.reduce_s(*args),
                     schur_reduce.reduce_s_rows_reference(*args, tables)):
        np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0, atol=1e-12 * np.abs(s_j).max())
        np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0, atol=1e-12 * np.abs(r_j).max())


@pytest.mark.parametrize("K", ar.KS)
def test_hand_jacobian_matches_autodiff(K):
    """The hand components-major Jacobian against the synthesized one
    (forward mode through the residual), at the generator's geometry:
    random rotations well past the small-angle series, short tracks' zero
    θ included."""
    data = ar.nrsfm_data(**SMALL, K=K)
    residual, jacobian = ar.nrsfm_model(torch, K)
    cam = torch.as_tensor(data["cameras"][data["cam_idx"]].T)
    x = torch.as_tensor(data["points"][data["pt_idx"]].T)
    meas = torch.as_tensor(data["observations"])
    r, j = jacobian(meas, cam, x)
    r_a, j_a = auto_cm_jacobian(residual, (pt.Euclidean(6), pt.Euclidean(3 * K)))(meas, cam, x)
    assert j.shape == (2, 6 + 3 * K, meas.shape[0])
    assert torch.equal(r, r_a)
    assert float((j - j_a).abs().max()) <= 1e-12 * float(j_a.abs().max())


@functools.lru_cache(maxsize=None)
def _jax_trace(K, adaptive=False):
    """The JAX package's float64 direct-Schur LM on the small problem (one
    run per case, shared by the checks); the adaptive form stops after
    :data:`ADAPTIVE_ITERS` iterations."""
    data = ar.nrsfm_data(**SMALL, K=K)
    if adaptive:
        jp, _, jpts, _ = ar.build(nt, ar.with_outliers(data), jnp.float64, adaptive=True)
    else:
        jp, _, jpts = ar.build(nt, data, jnp.float64)
    jax_perturb_ba(jp, jpts, ar.ADAPTIVE_PERTURB if adaptive else 0.05, seed=5)
    r = nt.optimize(jp, nt.Options(solver="schur", schur_family=nt.Euclidean(3 * K),
                                   rel_dcost=1e-6, max_time=float("inf"),
                                   max_iters=ADAPTIVE_ITERS if adaptive else 100,
                                   store_trajectory="jit"))
    return (r.num_iterations, r.linear_solves, r.termination, float(r.start_cost),
            np.asarray(r.trajectory.costs))


#: LM iterations of the adaptive form's trace (it descends slowly, far
#: from rel_dcost's stop).
ADAPTIVE_ITERS = 12


def _port_problem(K, adaptive=False):
    data = ar.nrsfm_data(**SMALL, K=K)
    if adaptive:
        tp, _, tpts, _ = ar.build(pt, ar.with_outliers(data), torch.float64, "cpu",
                                  adaptive=True)
    else:
        tp, _, tpts = ar.build(pt, data, torch.float64, "cpu")
    perturb_ba(tp, tpts, ar.ADAPTIVE_PERTURB if adaptive else 0.05, seed=5)
    return tp


@pytest.mark.parametrize("K", ar.KS)
def test_nrsfm_lm_trace_matches_jax(K):
    """Float64 LM on the small NRSfM problem (dl = 3K = 9 and 18) through
    the obs-major route (B1 at (2, 6, 3K), every dl past B3's to the damped
    inverses and B4's plain version) against the JAX package's direct
    solve: the same iterations, solves and termination, the cost trace
    within 1e-9 relative."""
    tp = _port_problem(K)
    fam = pt.Euclidean(3 * K)
    comp = pt.compile_problem(tp, solver="schur", schur_family=fam)
    info = comp.schur_info
    assert isinstance(info.fast[0], schur._FastBatch) and info.w_rows is not None
    assert info.dof_elim == 3 * K and not info.implicit and not info.generic_why
    r_t = pt.optimize(tp, pt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                                     max_time=float("inf")))
    iters, solves, term, start, costs = _jax_trace(K)
    assert (r_t.num_iterations, r_t.linear_solves, r_t.termination) == (iters, solves, term)
    np.testing.assert_allclose(r_t.start_cost, start, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, costs, rtol=1e-9)
    assert r_t.best_cost < 1e-2 * r_t.start_cost


def test_nrsfm_routes_give_one_system(monkeypatch):
    """At K = 6 the obs-major assembly (B1's plain version) and the generic
    one (the route a batch past ``kernel_takes`` would take) give one
    float64 system, within 1e-12 of its largest entry: the points whose
    short tracks keep 4–5 coefficients (zero Jacobian columns, their h_ll
    rows and columns 0) included.  The solve of such a point's exact zeros
    is the same on both routes: the damped inverse of h_ll + λI."""
    tp = _port_problem(6)
    fam = pt.Euclidean(18)
    x = tp.stacked_variables()
    obs = pt.compile_problem(tp, solver="schur", schur_family=fam)
    monkeypatch.setattr(fused_obs, "kernel_takes", lambda *a: False)
    gen = pt.compile_problem(tp, solver="schur", schur_family=fam)
    assert isinstance(obs.schur_info.fast[0], schur._FastBatch)
    assert not isinstance(gen.schur_info.fast[0], schur._FastBatch)
    (c_o, sys_o), (c_g, sys_g) = obs.assemble(x), gen.assemble(x)
    np.testing.assert_allclose(float(c_o), float(c_g), rtol=1e-14)
    for name, a, b in zip(("a_rr", "b_r", "h_ll", "g_l", "w"), sys_o, sys_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()), err_msg=name)
    h = sys_o[2]
    short = (h.diagonal(dim1=0, dim2=1) == 0).any(dim=1)  # [L]
    assert int(short.sum()) > 0 and torch.equal(h[:, :, short], sys_g[2][:, :, short])


def test_adaptive_nrsfm_trace_matches_jax():
    """The adaptive form (10% outliers, one shared ContaminatedGaussian)
    at K = 3 in float64 through the generic route (B6, B7, the damped
    inverses, B5's plain version) against the JAX package over
    :data:`ADAPTIVE_ITERS` iterations: the same iterations, solves and
    termination, the cost trace within 1e-9 relative."""
    tp = _port_problem(3, adaptive=True)
    fam = pt.Euclidean(9)
    info = pt.compile_problem(tp, solver="schur", schur_family=fam).schur_info
    assert not isinstance(info.fast[0], schur._FastBatch) and info.w_pairs is not None
    r_t = pt.optimize(tp, pt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                                     max_iters=ADAPTIVE_ITERS, max_time=float("inf")))
    iters, solves, term, start, costs = _jax_trace(3, adaptive=True)
    assert (r_t.num_iterations, r_t.linear_solves, r_t.termination) == (iters, solves, term)
    np.testing.assert_allclose(r_t.start_cost, start, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, costs, rtol=1e-9)
    assert r_t.best_cost < 0.5 * r_t.start_cost


def test_float32_obs_major_solve_takes_b4(monkeypatch):
    """A float32 obs-major W past B3's ``DAMPED_MAX_DL`` (NRSfM K = 3, dl
    9) is solved through the float64-formed damped inverses and B4, never
    B3: the dispatch table's B3 entry refuses, B1 and B4 count their
    calls over a few LM iterations."""
    from nllstpu_torch.core import optimize

    calls = {"assemble": 0, "reduce_lm": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    def refuse(*args):
        raise AssertionError("B3 reached past DAMPED_MAX_DL")

    k = optimize.KERNELS
    monkeypatch.setattr(optimize, "KERNELS", dataclasses.replace(
        k, assemble=counting("assemble", k.assemble), reduce=refuse,
        reduce_lm=counting("reduce_lm", k.reduce_lm)))
    tp, _, tpts = ar.build(pt, ar.nrsfm_data(**SMALL, K=3), torch.float32, "cpu")
    perturb_ba(tp, tpts, 0.05, seed=5)
    assert 9 > schur_reduce.DAMPED_MAX_DL
    r = pt.optimize(tp, pt.Options(solver="schur", schur_family=pt.Euclidean(9), max_iters=3,
                                   max_time=float("inf")))
    assert calls["assemble"] >= r.num_iterations and calls["reduce_lm"] == r.linear_solves > 0
