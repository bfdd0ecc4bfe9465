"""Kernels B3's and B4's tables of an obs-major W (``schur_reduce.row_tables``,
built by ``schur.w_structure`` in ``compile_problem``) and the plain versions that read
them, on the CPU: every real (landmark, camera) incidence once, fixed
cameras and pads nowhere, a landmark seen by fixed cameras only kept for
its inverse; the structured plain mirror of the kernels' order against
the dense plain versions; both against the JAX package's Pallas kernels
in interpret mode; and B3's float64-formed inverses on blocks singular to
float32.

Tolerances: the mirror and the dense plain version are the same float64
arithmetic summed in another order, 1e-12 of the largest entry.  Against
the JAX kernels: B4 in float64 at 1e-12 (as ``tests/test_torch_dual.py``
holds B4's plain version); B3 in float32 at 1e-5 of the largest entry of
s_sum and rhs and h_inv at rtol 1e-5, atol 1e-6 (as
``tests/test_torch_ops.py`` holds B3's plain version: float32 sums in
another order, and the port's inverses formed in float64, the JAX
kernel's in float32).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nllstpu_torch as pt
from nllstpu.ops.pallas.schur_reduce import reduce_s_lm as jax_reduce_s_lm
from nllstpu.ops.pallas.schur_reduce import reduce_s_lm_damped as jax_reduce_s_lm_damped
from nllstpu_torch.core.linearsolver import batched_inv_spd_cm
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
from nllstpu_torch.ops import schur, schur_reduce


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


def _compiled(case):
    """``(compiled problem, system)`` of a float64 direct problem whose W
    is obs-major: a uniform pinhole batch; a Snavely BAL batch in four
    degree buckets; the pinhole batch with cameras 1 and 2 fixed, where
    eight landmarks are seen by fixed cameras only."""
    if case == "bal-buckets":
        data = tbal.make_realistic_bal(ncameras=12, npoints=160, seed=3, noise=1e-3)
        p, _, pts = tbal.make_bal_problem(data, dtype=torch.float64, device="cpu")
        perturb_ba(p, pts, 0.05, seed=5)
        comp = pt.compile_problem(p, solver="schur", schur_family=tbal.PT)
    else:
        p, cams, lmks = make_pinhole_ba(8, 64, 0.3, noise=1e-3, dtype=torch.float64,
                                        batched="cm", device="cpu")
        perturb_ba(p, lmks, 0.03, seed=2)
        unfixed = cams[:1] + cams[3:] + lmks if case == "fixed-cameras" else None
        comp = pt.compile_problem(p, unfixed, solver="schur", schur_family=pt.Euclidean(3))
    return comp, comp.assemble(p.stacked_variables())[1]


CASES = ["uniform", "bal-buckets", "fixed-cameras"]


@pytest.mark.parametrize("case", CASES)
def test_row_tables_hold_each_incidence_once(case):
    comp, sys_ = _compiled(case)
    info = comp.schur_info
    (fast,) = info.fast
    rows = info.w_rows
    assert info.w_pairs is None
    assert len(fast.buckets) == (4 if case == "bal-buckets" else 1)
    L, n_r = info.num_elim, fast.n_r
    bcol, bwidth = schur_reduce.uniform_blocks(n_r, fast.dr_s)
    assert np.array_equal(rows.bcol, bcol) and np.array_equal(rows.bwidth, bwidth)
    assert rows.covered == n_r * fast.dr_s == sys_[4].shape[2]
    assert n_r == {"uniform": 8, "bal-buckets": 12, "fixed-cameras": 6}[case]
    lmk, blk = np.asarray(rows.lmk), np.asarray(rows.blk)
    # Every real incidence once (fixed cameras: rvid == n_r; pads: lid == L).
    real = (fast.lid < L) & (fast.rvid < n_r)
    want = np.unique(fast.lid[real].astype(np.int64) * n_r + fast.rvid[real])
    got = lmk[blk >= 0].astype(np.int64) * n_r + blk[blk >= 0]
    assert np.array_equal(got, want)
    assert blk.max() < n_r and lmk.max() < L
    # Sorted by landmark, then block; every landmark at least once, and a
    # landmark without a block exactly once.
    assert np.all(np.diff(lmk.astype(np.int64) * (n_r + 1) + blk) > 0)
    assert np.array_equal(np.unique(lmk), np.arange(L))
    alone = lmk[blk < 0]
    assert not np.isin(alone, lmk[blk >= 0]).any()
    assert (alone.size > 0) == (case == "fixed-cameras")
    # W lies in the structure: a landmark's row is zero outside its blocks.
    w = sys_[4].reshape(L, -1, n_r, fast.dr_s).transpose(1, 2)  # [L, n_r, dl, dr_s]
    held = np.zeros((L, n_r), dtype=bool)
    held[lmk[blk >= 0], blk[blk >= 0]] = True
    assert not w[torch.from_numpy(~held)].any()
    # Links: every pair of a landmark's incidences once, on its block pair,
    # in landmark order within a pair, cut into items of LINK_CHUNK.
    links, items, istarts = (np.asarray(t) for t in (rows.links, rows.items, rows.istarts))
    pairs = np.asarray(rows.pairs)
    assert pairs.shape[0] == n_r * (n_r + 1) // 2 and np.all(pairs[:, 0] <= pairs[:, 1])
    inc = np.nonzero(blk >= 0)[0]
    by_lmk = {}
    for s in inc:
        by_lmk.setdefault(lmk[s], []).append(s)
    want_links = sorted((a, b) for ss in by_lmk.values() for i, a in enumerate(ss) for b in ss[i:])
    assert sorted(map(tuple, links)) == want_links
    assert np.all(items[:, 2] - items[:, 1] <= schur_reduce.LINK_CHUNK)
    assert np.array_equal(items[:, 1][1:], items[:, 2][:-1]) and items[-1, 2] == len(links)
    for p in range(pairs.shape[0]):
        its = items[istarts[p] : istarts[p + 1]]
        assert np.all(its[:, 0] == p)
        if len(its):
            ln = links[its[0, 1] : its[-1, 2]]
            assert np.all(blk[ln[:, 0]] == pairs[p, 0]) and np.all(blk[ln[:, 1]] == pairs[p, 1])
            assert np.all(np.diff(lmk[ln[:, 0]]) > 0)


def test_row_tables_only_for_obs_major_direct_w():
    """The implicit backend builds no W tables; the obs-major direct W
    its tables as ``w_rows`` (B3/B4), never as ``w_pairs`` (B5)."""
    p, _, lmks = make_pinhole_ba(6, 40, 0.5, noise=1e-3, dtype=torch.float64, batched="cm",
                                 device="cpu")
    info = pt.compile_problem(p, solver="schur_cg", schur_family=pt.Euclidean(3)).schur_info
    assert info.implicit and info.w_rows is None and info.w_pairs is None
    info = pt.compile_problem(p, solver="schur", schur_family=pt.Euclidean(3)).schur_info
    assert info.w_rows is not None and info.w_pairs is None and info.table_seconds > 0


@pytest.mark.parametrize("case", CASES)
def test_row_mirror_matches_dense(case):
    """B4's and B3's structured mirror over a real assembly's W equals the
    dense plain versions (float64, 1e-12), s_sum exactly symmetric; B3's
    inverses are ``SchurOps.damped_inverse``'s, the landmarks without a
    block included."""
    comp, (a_rr, b_r, h_ll, g_l, w) = _compiled(case)
    rows = comp.schur_info.w_rows
    lam = 1e-3 * float(torch.diagonal(h_ll).abs().max())
    s_d, r_d, hi_d = schur_reduce.reduce_s_damped_reference(w, h_ll, g_l, lam, rows)
    hi = schur.SchurOps.damped_inverse(h_ll, lam)
    assert torch.equal(hi_d, hi) and torch.isfinite(hi).all()
    s_m, r_m = schur_reduce.reduce_s_rows_reference(w, hi, g_l, rows)
    _close(s_m, s_d, 1e-12)
    _close(r_m, r_d, 1e-12)
    assert torch.equal(s_m, s_m.T)
    s4, r4 = schur_reduce.reduce_s_lm(w, hi, g_l, rows)  # the CPU dispatcher: dense
    assert torch.equal(s4, s_d) and torch.equal(r4, r_d)


def test_rows_against_jax_kernels():
    """On the fixed-cameras system (wc = 36): B4's mirror against
    ``reduce_s_lm`` in float64 and B3's plain version against
    ``reduce_s_lm_damped`` in float32, both in interpret mode."""
    comp, (_, _, h_ll, g_l, w) = _compiled("fixed-cameras")
    rows = comp.schur_info.w_rows
    lam = 1e-3 * float(torch.diagonal(h_ll).abs().max())
    hi = schur.SchurOps.damped_inverse(h_ll, lam)
    s_t, r_t = schur_reduce.reduce_s_rows_reference(w, hi, g_l, rows)
    w_j = w.permute(1, 2, 0).numpy()  # the JAX kernels' landmark-minor [dl, wc, L]
    s_j, r_j = jax_reduce_s_lm(*(jnp.asarray(x) for x in (w_j, hi.numpy(), g_l.numpy())),
                               interpret=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-12)
    f32 = [t.float() for t in (w, h_ll, g_l)]
    s_t, r_t, hi_t = schur_reduce.reduce_s_damped(*f32, lam, rows)
    s_j, r_j, hi_j = jax_reduce_s_lm_damped(
        jnp.asarray(w_j.astype(np.float32)), jnp.asarray(f32[1].numpy()),
        jnp.asarray(f32[2].numpy()), lam, interpret=True,
    )
    s_j, r_j = np.asarray(s_j), np.asarray(r_j)
    assert np.abs(s_t.numpy() - s_j).max() <= 1e-5 * np.abs(s_j).max()
    assert np.abs(r_t.numpy() - r_j).max() <= 1e-5 * np.abs(r_j).max()
    np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), rtol=1e-5, atol=1e-6)


def test_damped_inverse_finite_on_blocks_singular_to_float32():
    """Blocks with eigenvalues 1e4, 1e4 and 1e-4 against λ = 3e-4 (the
    Dubrovnik-class float32 problem's at its eighth iteration), and one
    whose damped diagonal rounds back to an exactly singular float32
    block: B3's plain version forms their inverses in float64, finite and
    within float32 rounding (1e-6) of the float64 inverse of the same
    float32 blocks, where the float32 closed form is infinite on the
    singular block and off by over 1% on others."""
    rng = np.random.default_rng(0)
    L, lam = 64, 3e-4
    q, _ = np.linalg.qr(rng.standard_normal((L, 3, 3)))
    h = np.einsum("lab,b,lcb->acl", q, np.array([1e4, 1e4, 1e-4]), q)
    h[:, :, 0] = [[1e4, 1e4, 0.0], [1e4, 1e4, 0.0], [0.0, 0.0, 1.0]]
    h32 = torch.from_numpy(0.5 * (h + h.transpose(1, 0, 2))).float()
    w = torch.from_numpy(rng.standard_normal((L, 3, 12))).float()
    g = torch.from_numpy(rng.standard_normal((3, L))).float()
    rows = schur_reduce.row_tables(np.repeat(np.arange(L), 2), np.arange(2 * L) % 2, L,
                                   *schur_reduce.uniform_blocks(2, 6))
    s, r, hi = schur_reduce.reduce_s_damped(w, h32, g, lam, rows)
    exact = batched_inv_spd_cm(h32.double() + lam * torch.eye(3, dtype=torch.float64)[:, :, None])
    assert torch.isfinite(hi).all() and torch.isfinite(s).all() and torch.isfinite(r).all()
    rel = (hi.double() - exact).abs().amax((0, 1)) / exact.abs().amax((0, 1))
    assert float(rel.max()) <= 1e-6
    f32 = batched_inv_spd_cm(h32 + lam * torch.eye(3)[:, :, None])
    assert not torch.isfinite(f32[:, :, 0]).all()
    rel32 = (f32[:, :, 1:].double() - exact[:, :, 1:]).abs().amax((0, 1)) / exact[:, :, 1:].abs().amax((0, 1))
    assert float(rel32.max()) > 1e-2
