"""Kernel twins of the PyTorch port against the JAX package's Pallas
kernels (run in interpret mode on the CPU).

Both sides get the same numpy inputs.  B1 (``fused_obs_all``) and B2
(``fused_obs_all_into``) are compared in float64 at rtol 1e-10 with W taken
from the p-major layout to the standard basis; their camera sums, made
from per-slot rows in camera order, against the JAX kernels' ``ab``.  B3
(``reduce_s_damped``) is compared in float32: the JAX kernel's S
contraction is bf16x3 (~1e-6 relative), so s_sum and rhs_sum are held to
1e-5 of their largest entry.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nllstpu.ops.pallas.fused_obs import fused_obs_all_pm, fused_obs_all_pm_into
from nllstpu.ops.pallas.schur_reduce import reduce_s_lm_damped
from nllstpu_torch.ops import fused_obs, schur_reduce, segment_sum


def _b1_inputs(seed, K, L, n_r, e_start, n=2, dr_s=6, dl=3):
    """Random B1 inputs with a duplicated (landmark, camera) pair in every
    run, dustbin pad slots (zero weights), and Huber-like weights: ρ′ in
    (0, 1] and a non-zero 2ρ″."""
    rng = np.random.default_rng(seed)
    s = dr_s + dl
    jac = rng.standard_normal((n, s, K, L))
    g0 = rng.standard_normal((s, K, L))
    d1 = rng.random((K, L)) + 0.05
    d2 = -0.2 * rng.random((K, L))
    vc = rng.integers(0, n_r, (K, L)).astype(np.int32)
    vc[1] = vc[0]  # each landmark seen twice by the same camera
    pad = np.zeros((K, L), dtype=bool)
    pad[K - 1, ::3] = True  # pad slots at the end of some runs
    vc[pad] = n_r
    d1[pad] = 0.0
    d2[pad] = 0.0
    return jac, g0, d1, d2, vc


def _pm_to_std(w_pm, n_r, dr_s, dl):
    """JAX p-major ``[dl, dr_s·NRp, L]`` → port ``[L, dl, n_r·dr_s]``."""
    L = w_pm.shape[-1]
    nrp = w_pm.shape[1] // dr_s
    w = np.asarray(w_pm).reshape(dl, dr_s, nrp, L)[:, :, :n_r]
    return w.transpose(3, 0, 2, 1).reshape(L, dl, n_r * dr_s)


@pytest.mark.parametrize("K,L,n_r,e_start", [(5, 37, 11, 6), (4, 20, 7, 0)])
def test_fused_obs_twin_matches_pallas(K, L, n_r, e_start):
    dr_s, dl = 6, 3
    inputs = _b1_inputs(0, K, L, n_r, e_start)
    h, g, w_pm, ab = fused_obs_all_pm(
        *(jnp.asarray(x) for x in inputs), n_r, dr_s, dl, e_start,
        interpret=True,
    )
    t_in = [torch.from_numpy(x) for x in inputs]
    h2, g2, w2, ab2 = fused_obs.fused_obs_all_reference(
        *t_in, *fused_obs.camera_tables(t_in[4], n_r), n_r, dr_s, dl, e_start
    )
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h), **tol)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g), **tol)
    np.testing.assert_allclose(
        w2.numpy(), _pm_to_std(w_pm, n_r, dr_s, dl), **tol
    )
    np.testing.assert_allclose(ab2.numpy().T, np.asarray(ab)[:, :n_r], **tol)
    # The duplicated camera really was added twice somewhere.
    assert np.abs(w2.numpy()).max() > 0


def test_fused_obs_dispatch_cpu_runs_twin():
    """On CPU tensors the dispatcher runs the plain version and launches
    nothing."""
    inputs = [torch.from_numpy(x) for x in _b1_inputs(1, 3, 9, 5, 6)]
    inputs += fused_obs.camera_tables(inputs[4], 5)
    before, before_b6 = fused_obs.LAUNCHES, segment_sum.LAUNCHES
    out = fused_obs.fused_obs_all(*inputs, 5, 6, 3, 6)
    ref = fused_obs.fused_obs_all_reference(*inputs, 5, 6, 3, 6)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert fused_obs.LAUNCHES == before and segment_sum.LAUNCHES == before_b6


#: B2 cases: (dr_s, e_start, n_r, L_total, calls), each call (K, l_base,
#: L_b) a bucket of the JAX package's layout.  The second case chains a
#: chunk bucket over the heavy prefix and the class bucket that covers the
#: same landmarks.  The port takes the calls' tiles as one batch, each
#: landmark's slots from every call, through one set of buffers.  Few
#: calls with short runs: each interpret-mode call of the Pallas kernel
#: compiles for seconds.
INTO_CASES = {
    "l_base 37, dr_s 6": (6, 0, 7, 120, [(2, 37, 50)]),
    "chunk + class, dr_s 9": (9, 9, 11, 64, [(2, 0, 7), (2, 0, 30)]),
}


def _tiles_as_batch(inputs, calls, l_total, n_r):
    """The calls' K-major tiles as one batch, call by call and landmark by
    landmark (slot k of the call's landmark l at column c0 + l·K + k), with
    kernel B2's tables and the camera order over it: ``[jac, g0, d1, d2,
    vc, cpos], slots, cstarts`` as tensors."""
    cat = np.concatenate
    batch = [
        cat([np.swapaxes(x[0], 2, 3).reshape(*x[0].shape[:2], -1) for x in inputs], axis=2),
        cat([np.swapaxes(x[1], 1, 2).reshape(x[1].shape[0], -1) for x in inputs], axis=1),
        *(cat([x[i].T.reshape(-1) for x in inputs]) for i in (2, 3, 4)),
    ]
    lid = cat([l_base + np.repeat(np.arange(lb), K) for K, l_base, lb in calls])
    cpos, cstarts = fused_obs.camera_order(batch[4], n_r)
    slots = fused_obs.slot_tables(lid, batch[4], l_total, n_r)
    return ([torch.from_numpy(t) for t in batch + [cpos]],
            fused_obs.SlotTables(*(torch.from_numpy(t) for t in slots)),
            torch.from_numpy(cstarts))


@pytest.mark.parametrize("case", sorted(INTO_CASES))
def test_fused_obs_into_twin_matches_pallas(case):
    dr_s, e_start, n_r, l_total, calls = INTO_CASES[case]
    dl = 3
    nrp = -(-n_r // 128) * 128
    w_pm = jnp.zeros((dl, dr_s * nrp, l_total), dtype=jnp.float64)
    h_j = np.zeros((dl, dl, l_total))
    g_j = np.zeros((dl, l_total))
    ab_j = 0.0
    inputs = [_b1_inputs(10 + i, K, lb, n_r, e_start, dr_s=dr_s)
              for i, (K, _, lb) in enumerate(calls)]
    for (K, l_base, lb), x in zip(calls, inputs):
        h, g, w_pm, ab, la = fused_obs_all_pm_into(
            *(jnp.asarray(a) for a in x), w_pm, l_base, n_r, dr_s, dl,
            e_start, interpret=True,
        )
        h_j[:, :, la : la + h.shape[-1]] += np.asarray(h)
        g_j[:, la : la + g.shape[-1]] += np.asarray(g)
        ab_j = ab_j + np.asarray(ab)[:, :n_r]
    batch, slots, cstarts = _tiles_as_batch(inputs, calls, l_total, n_r)
    h_t, g_t, w_t, rows_t = fused_obs.zero_buffers(
        l_total, n_r, dr_s, dl, int(cstarts[-1]), torch.float64, "cpu"
    )
    fused_obs.fused_obs_all_into_reference(
        *batch, slots, h_t, g_t, w_t, rows_t, n_r, dr_s, dl, e_start,
    )
    ab_t = segment_sum.segment_block_sum_reference(rows_t, cstarts).T
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(h_t.numpy(), h_j, **tol)
    np.testing.assert_allclose(g_t.numpy(), g_j, **tol)
    np.testing.assert_allclose(w_t.numpy(), _pm_to_std(w_pm, n_r, dr_s, dl), **tol)
    np.testing.assert_allclose(ab_t.numpy(), ab_j, **tol)
    # Landmarks outside every call's range stay exactly zero.
    covered = np.zeros(l_total, dtype=bool)
    for _, l_base, lb in calls:
        covered[l_base : l_base + lb] = True
    assert not w_t.numpy()[~covered].any() and not h_t.numpy()[..., ~covered].any()
    assert w_t.numpy()[covered].any()


def test_fused_obs_into_dispatch_cpu_runs_twin():
    """On CPU tensors B2's dispatcher runs the plain version and launches
    nothing; over one tile taken as a batch, into zeroed buffers, then B6
    over the camera runs, it is B1."""
    x = _b1_inputs(2, 3, 9, 5, 0, dr_s=9)
    inputs = [torch.from_numpy(a) for a in x]
    cpos, cstarts = fused_obs.camera_tables(inputs[4], 5)
    ref = fused_obs.fused_obs_all_reference(*inputs, cpos, cstarts, 5, 9, 3, 0)
    batch, slots, cstarts_b = _tiles_as_batch([x], [(3, 0, 9)], 9, 5)
    assert torch.equal(cstarts_b, cstarts)
    bufs = fused_obs.zero_buffers(9, 5, 9, 3, int(cstarts[-1]), torch.float64, "cpu")
    before = fused_obs.INTO_LAUNCHES
    assert fused_obs.fused_obs_all_into(*batch, slots, *bufs, 5, 9, 3, 0) is None
    got = (*bufs[:3], segment_sum.segment_block_sum(bufs[3], cstarts))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert fused_obs.INTO_LAUNCHES == before


def _b3_inputs(seed, L, wc, dl=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((L, dl, wc)).astype(np.float32)
    a = rng.standard_normal((dl, dl, L)).astype(np.float32)
    # SPD with a boosted diagonal so the λ = 0 inverse is well conditioned.
    h_ll = (
        np.einsum("del,fel->dfl", a, a) + 2.0 * np.eye(dl)[:, :, None]
    ).astype(np.float32)
    g_l = rng.standard_normal((dl, L)).astype(np.float32)
    return w, h_ll, g_l


@pytest.mark.parametrize("wc", [128, 1152])
@pytest.mark.parametrize("lam", [0.0, 1e-2])
def test_reduce_s_damped_twin_matches_pallas(wc, lam):
    L = 300 if wc == 128 else 200
    w, h_ll, g_l = _b3_inputs(7, L, wc)
    s_j, r_j, hi_j = reduce_s_lm_damped(
        jnp.asarray(w.transpose(1, 2, 0)), jnp.asarray(h_ll),
        jnp.asarray(g_l), lam, interpret=True,
    )
    s_t, r_t, hi_t = schur_reduce.reduce_s_damped_reference(
        torch.from_numpy(w), torch.from_numpy(h_ll), torch.from_numpy(g_l), lam
    )
    s_j, r_j = np.asarray(s_j), np.asarray(r_j)
    assert np.abs(s_t.numpy() - s_j).max() <= 1e-5 * np.abs(s_j).max()
    assert np.abs(r_t.numpy() - r_j).max() <= 1e-5 * np.abs(r_j).max()
    np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), rtol=1e-5, atol=1e-6)


def test_reduce_s_damped_twin_f64_exact_math():
    """In float64 the twin is the textbook Σ WᵀH⁻¹W: check it against a
    per-landmark numpy loop."""
    rng = np.random.default_rng(3)
    L, dl, wc, lam = 6, 3, 10, 0.3
    w = rng.standard_normal((L, dl, wc))
    a = rng.standard_normal((L, dl, dl))
    h = np.einsum("lde,lfe->lfd", a, a) + np.eye(dl)
    g = rng.standard_normal((L, dl))
    s_ref = np.zeros((wc, wc))
    r_ref = np.zeros(wc)
    for l in range(L):
        hinv = np.linalg.inv(h[l] + lam * np.eye(dl))
        s_ref += w[l].T @ hinv @ w[l]
        r_ref += w[l].T @ hinv @ g[l]
    s, r, hi = schur_reduce.reduce_s_damped_reference(
        torch.from_numpy(w), torch.from_numpy(h.transpose(1, 2, 0).copy()),
        torch.from_numpy(g.T.copy()), lam,
    )
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-12, atol=1e-12)
    assert hi.shape == (dl, dl, L)


def test_reduce_s_damped_dispatch_cpu_runs_twin():
    w, h_ll, g_l = (torch.from_numpy(x) for x in _b3_inputs(5, 40, 24))
    before = schur_reduce.LAUNCHES
    out = schur_reduce.reduce_s_damped(w, h_ll, g_l, 1e-3)
    ref = schur_reduce.reduce_s_damped_reference(w, h_ll, g_l, 1e-3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert schur_reduce.LAUNCHES == before
