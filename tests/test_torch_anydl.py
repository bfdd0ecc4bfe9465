"""The direct Schur solve at landmark blocks past the unrolled dl ≤ 6, on
the CPU: kernel B5's plain versions at dl = 18 against the JAX package's
interpret-mode Pallas ``reduce_s``, and trajectory-space NRSfM
(``scripts_torch/anydl_reference.py``: K DCT coefficients per axis, dl =
3K) through the generic route against the JAX package's direct solve.

Tolerances: the reduction to rtol 1e-12 of the largest entry (the same
float64 products, summed in another order); the LM traces to 1e-9
relative with the same iterations, solves and termination, as the port's
other float64 trace tests, stopping at ``rel_dcost=1e-6`` before the
float64 floor; the hand Jacobian to 1e-12 of the largest entry against
``auto_cm_jacobian``'s forward mode."""

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
from nllstpu_torch.ops import schur, schur_reduce
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
def _jax_trace(K):
    """The JAX package's float64 direct-Schur LM on the small problem (one
    run per K, shared by the checks)."""
    jp, _, jpts = ar.build(nt, ar.nrsfm_data(**SMALL, K=K), jnp.float64)
    jax_perturb_ba(jp, jpts, 0.05, seed=5)
    r = nt.optimize(jp, nt.Options(solver="schur", schur_family=nt.Euclidean(3 * K),
                                   rel_dcost=1e-6, max_time=float("inf"),
                                   store_trajectory="jit"))
    return (r.num_iterations, r.linear_solves, r.termination, float(r.start_cost),
            np.asarray(r.trajectory.costs))


@pytest.mark.parametrize("K", ar.KS)
def test_nrsfm_lm_trace_matches_jax(K):
    """Float64 LM on the small NRSfM problem (dl = 3K = 9 and 18) through
    the generic route (B6 keyed sums, B7, the damped inverses, B5's plain
    version) against the JAX package's direct solve: the same iterations,
    solves and termination, the cost trace within 1e-9 relative."""
    tp, _, tpts = ar.build(pt, ar.nrsfm_data(**SMALL, K=K), torch.float64, "cpu")
    perturb_ba(tp, tpts, 0.05, seed=5)
    fam = pt.Euclidean(3 * K)
    comp = pt.compile_problem(tp, solver="schur", schur_family=fam)
    info = comp.schur_info
    assert isinstance(info.fast[0], schur._GenBatch) and info.w_pairs is not None
    assert info.dof_elim == 3 * K and not info.implicit
    r_t = pt.optimize(tp, pt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                                     max_time=float("inf")))
    iters, solves, term, start, costs = _jax_trace(K)
    assert (r_t.num_iterations, r_t.linear_solves, r_t.termination) == (iters, solves, term)
    np.testing.assert_allclose(r_t.start_cost, start, rtol=1e-12)
    np.testing.assert_allclose(r_t.costs, costs, rtol=1e-9)
    assert r_t.best_cost < 1e-2 * r_t.start_cost
