"""The camera side of the direct assembly against the JAX package, on the
CPU in float64: the compile-time tables that put every observation's
camera terms in camera order (``cpos``/``cstarts``), the two-stage plain
versions of kernels B1 and B2 (per-slot camera rows, then kernel B6's
plain version over the camera runs) against the Pallas kernels in
interpret mode, the whole skewed assembly against the JAX package's, and
the plain mirror of kernel B6's chunk order.  Also: compiling on the CPU
never builds the CUDA library.

Tolerances: the assembled blocks to 1e-12 of the largest entry (the same
float64 arithmetic, summed in another order); the chunk mirror against
B6's plain version to 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.ops.pallas.fused_obs import fused_obs_all_pm, fused_obs_all_pm_into
import nllstpu_torch as pt
from nllstpu_torch.core import optimize
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
from nllstpu_torch.ops import _build, fused_obs, schur, segment_sum

#: ``make_realistic_bal`` arguments of a skewed problem whose plan starts
#: with a chunk bucket (as tests/test_torch_bal.py's "chunk bucket").
CHUNK = ((80, 160), dict(seed=3, noise=1e-3, track_alpha=1.0, max_track=80))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


def _skewed_pair():
    (nc, npt), kw = CHUNK
    jp, _, jpts = jbal.make_bal_problem(jbal.make_realistic_bal(nc, npt, **kw), dtype=jnp.float64)
    jax_perturb_ba(jp, jpts, 0.05, seed=5)
    tp, _, tpts = tbal.make_bal_problem(
        tbal.make_realistic_bal(nc, npt, **kw), dtype=torch.float64, device="cpu"
    )
    perturb_ba(tp, tpts, 0.05, seed=5)
    return jp, tp


def _compiled(case):
    """``(compiled, problem, number of fixed cameras)``."""
    if case == "skewed, chunk bucket":
        p = _skewed_pair()[1]
        return pt.compile_problem(p, solver="schur", schur_family=tbal.PT), p, 0
    p, cams, lmks = make_pinhole_ba(7, 40, 0.6, noise=1e-3, dtype=torch.float64, batched="cm",
                                    device="cpu")
    perturb_ba(p, lmks, 0.05, seed=5)
    if case == "pinhole":
        return pt.compile_problem(p, solver="schur", schur_family=pt.Euclidean(3)), p, 0
    return pt.compile_problem(p, cams[2:] + lmks, solver="schur",
                              schur_family=pt.Euclidean(3)), p, 2


@pytest.mark.parametrize("case", ["pinhole", "skewed, chunk bucket", "first two cameras fixed"])
def test_camera_tables(case):
    """``cam_pos`` is a bijection from the batch's non-dustbin columns onto
    the rows of the camera order, cameras ascending and stable within a
    camera; dustbin columns (pads, masked costs, fixed cameras) are −1;
    ``cam_starts`` are the camera runs; the device tables are the per-bucket
    ``[k_b, L_b]`` tiles of it."""
    comp, _, n_fixed = _compiled(case)
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    if case == "skewed, chunk bucket":
        assert len(fast.buckets) == 7 and fast.buckets[0][3] == 0
    rvid, cpos, cstarts = fast.rvid, fast.cam_pos, fast.cam_starts
    real = rvid < fast.n_r
    assert cpos.dtype == np.int32 and cstarts.dtype == np.int32
    assert np.all(cpos[~real] == -1)
    assert np.array_equal(np.sort(cpos[real]), np.arange(real.sum()))
    order = np.empty(real.sum(), dtype=np.int64)
    order[cpos[real]] = np.nonzero(real)[0]  # column at each row of the order
    assert np.all(np.diff(rvid[order]) >= 0)
    same = np.diff(rvid[order]) == 0
    assert np.all(np.diff(order)[same] > 0)  # stable within a camera
    assert np.array_equal(cstarts, np.concatenate([[0], np.cumsum(np.bincount(rvid[real], minlength=fast.n_r))]))
    if n_fixed:
        cam_slot = fast.r_slot
        fixed_cols = np.asarray(batch.idx[cam_slot].numpy()) < n_fixed
        mask = batch.mask.numpy()
        assert (fixed_cols & mask).any() and np.all(cpos[fixed_cols] == -1)
        assert fast.n_r == 7 - n_fixed
    assert fast.cpos_all.dtype == torch.int32 and np.array_equal(fast.cpos_all.numpy(), cpos)
    assert np.array_equal(fast.vc_all.numpy(), rvid)
    if len(fast.buckets) == 1:
        ((_, lb, kb, c0),) = fast.buckets
        vc, cp = fast.vc, fast.cpos
        assert cp.dtype == torch.int32 and cp.shape == vc.shape == (kb, lb)
        assert np.array_equal(cp.numpy(), cpos[c0 : c0 + lb * kb].reshape(lb, kb).T)
        assert np.array_equal((cp.numpy() < 0), (vc.numpy() == fast.n_r))
    else:
        assert fast.vc is None and fast.cpos is None
    assert np.array_equal(fast.cstarts.numpy(), cstarts)


def _pm_to_std(w_pm, n_r, dr_s, dl):
    """JAX p-major ``[dl, dr_s·NRp, L]`` → port ``[L, dl, n_r·dr_s]``."""
    L = w_pm.shape[-1]
    nrp = w_pm.shape[1] // dr_s
    w = np.asarray(w_pm).reshape(dl, dr_s, nrp, L)[:, :, :n_r]
    return w.transpose(3, 0, 2, 1).reshape(L, dl, n_r * dr_s)


def test_b1_two_stage_plain_matches_pallas():
    """B1's plain version (camera rows at ``cpos``, then B6's plain version
    over ``cstarts``) on a compiled pinhole problem's own tiles, its first
    two cameras fixed (their slots in the dustbin), against
    ``fused_obs_all_pm`` in interpret mode."""
    comp, problem, _ = _compiled("first two cameras fixed")
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, args = schur.fused_inputs(
        batch, problem.stacked_variables(), comp.schur_info, fast, torch.float64
    )
    jac, g0, d1m, d2m, vc, n_r, dr_s, dl, e_start = args
    h, g, w, ab = fused_obs.fused_obs_all(
        jac, g0, d1m, d2m, vc, fast.cpos, fast.cstarts, n_r, dr_s, dl, e_start
    )
    h_j, g_j, w_pm, ab_j = fused_obs_all_pm(
        *(jnp.asarray(t.contiguous().numpy()) for t in (jac, g0, d1m, d2m, vc)),
        n_r, dr_s, dl, e_start, interpret=True,
    )
    _close(h.numpy(), h_j)
    _close(g.numpy(), g_j)
    _close(w.numpy(), _pm_to_std(w_pm, n_r, dr_s, dl))
    assert ab.shape == (n_r, dr_s * (dr_s + 3) // 2)
    _close(ab.numpy().T, np.asarray(ab_j)[:, :n_r])


def _b1_inputs(seed, K, L, n_r, e_start, dr_s):
    """Random B1 inputs with a camera seen twice in every run and dustbin
    pad slots with zero weights."""
    rng = np.random.default_rng(seed)
    s = dr_s + 3
    jac, g0 = rng.standard_normal((2, s, K, L)), rng.standard_normal((s, K, L))
    d1, d2 = rng.random((K, L)) + 0.05, -0.2 * rng.random((K, L))
    vc = rng.integers(0, n_r, (K, L)).astype(np.int32)
    vc[1] = vc[0]
    pad = np.zeros((K, L), dtype=bool)
    pad[K - 1, ::3] = True
    vc[pad] = n_r
    d1[pad] = d2[pad] = 0.0
    return jac, g0, d1, d2, vc


def _tiles_as_batch(inputs, calls, l_total, n_r):
    """The calls' K-major tiles as one batch, call by call and landmark by
    landmark (slot k of the call's landmark l at column c0 + l·K + k), and
    kernel B2's tables over it: ``(jac, g0, d1, d2, vc, lid), slots``."""
    cat = np.concatenate
    batch = (
        cat([np.swapaxes(x[0], 2, 3).reshape(*x[0].shape[:2], -1) for x in inputs], axis=2),
        cat([np.swapaxes(x[1], 1, 2).reshape(x[1].shape[0], -1) for x in inputs], axis=1),
        *(cat([x[i].T.reshape(-1) for x in inputs]) for i in (2, 3, 4)),
        cat([l_base + np.repeat(np.arange(lb), K) for K, l_base, lb in calls]),
    )
    tables = fused_obs.slot_tables(batch[5], batch[4], l_total, n_r)
    return batch, fused_obs.SlotTables(*(torch.from_numpy(t) for t in tables))


def test_b2_two_stage_plain_matches_pallas():
    """B2's plain version over a chunk bucket and a class bucket at an
    unaligned l_base that covers it again, taken as one batch (each
    landmark's slots from both buckets), its camera rows in one camera
    order, then B6's plain version, against ``fused_obs_all_pm_into`` in
    interpret mode per bucket (``ab`` summed over the calls as the JAX
    package adds them)."""
    dr_s, dl, e_start, n_r, l_total = 9, 3, 9, 11, 90
    calls = [(2, 0, 7), (2, 3, 41)]  # (K, l_base, L_b)
    inputs = [_b1_inputs(20 + i, K, lb, n_r, e_start, dr_s) for i, (K, _, lb) in enumerate(calls)]
    (jac, g0, d1, d2, vc, _), slots = _tiles_as_batch(inputs, calls, l_total, n_r)
    cpos, cstarts = fused_obs.camera_order(vc, n_r)
    h_t, g_t, w_t, rows = fused_obs.zero_buffers(
        l_total, n_r, dr_s, dl, int(cstarts[-1]), torch.float64, "cpu"
    )
    fused_obs.fused_obs_all_into(
        *(torch.from_numpy(a) for a in (jac, g0, d1, d2, vc, cpos)), slots,
        h_t, g_t, w_t, rows, n_r, dr_s, dl, e_start,
    )
    nrp = 128
    w_pm = jnp.zeros((dl, dr_s * nrp, l_total), dtype=jnp.float64)
    h_j, g_j, ab_j = np.zeros((dl, dl, l_total)), np.zeros((dl, l_total)), 0.0
    for (K, l_base, lb), x in zip(calls, inputs):
        h, g, w_pm, ab, la = fused_obs_all_pm_into(
            *(jnp.asarray(a) for a in x), w_pm, l_base, n_r, dr_s, dl, e_start,
            interpret=True,
        )
        h_j[:, :, la : la + h.shape[-1]] += np.asarray(h)
        g_j[:, la : la + g.shape[-1]] += np.asarray(g)
        ab_j = ab_j + np.asarray(ab)[:, :n_r]
    ab_t = segment_sum.segment_block_sum(rows, torch.from_numpy(cstarts))
    _close(h_t.numpy(), h_j)
    _close(g_t.numpy(), g_j)
    _close(w_t.numpy(), _pm_to_std(w_pm, n_r, dr_s, dl))
    _close(ab_t.numpy().T, ab_j)


def test_skewed_assembly_matches_jax():
    """The whole bucketed system (B2's plain version over the batch, one
    camera sum) against the JAX package's assembly of the same skewed problem."""
    jp, tp = _skewed_pair()
    jc = jax_compile(jp, solver="schur", schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    assert len(tc.schur_info.fast[0].buckets) == 7
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-13)
    for a, b in zip(sys_t[:4], sys_j[:4]):
        _close(a.numpy(), b)
    _close(sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2))


def _runs(lengths, lead=0, tail=0, seed=0, d=5):
    rng = np.random.default_rng(seed)
    starts = lead + np.concatenate([[0], np.cumsum(lengths)])
    data = rng.standard_normal((int(starts[-1]) + tail, d))
    return torch.from_numpy(data), starts


#: (lengths, rows before the first run, rows after the last, rows per chunk)
MIRROR_CASES = {
    "empty runs": ([0, 3, 0, 0, 5, 0, 1, 0], 0, 0, 2),
    "one run across many chunks": ([2, 500, 1], 0, 0, 7),
    "many one-row runs": ([1] * 300 + [0, 2], 0, 0, 16),
    "rows outside the runs": ([4, 0, 9, 2], 6, 5, 3),
    "default chunk, long and short runs": ([1] * 40 + [5000] + [1] * 40 + [0], 2, 3, None),
}


@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_chunk_mirror_matches_reference(case, index):
    """The plain mirror of kernel B6's two passes (chunks, partials in
    chunk order) against B6's plain version."""
    lengths, lead, tail, rows = MIRROR_CASES[case]
    data, starts = _runs(np.array(lengths), lead, tail, seed=len(lengths))
    st = torch.from_numpy(starts).to(index)
    got = segment_sum.segment_block_sum_chunked(data, st, rows)
    ref = segment_sum.segment_block_sum_reference(data, st)
    assert got.shape == ref.shape == (len(lengths), data.shape[1])
    empty = np.array(lengths) == 0
    assert not got[torch.from_numpy(empty)].any()
    _close(got.numpy(), ref.numpy())


def test_compile_on_cpu_never_builds(monkeypatch):
    """``compile_problem`` builds the kernel library for a CUDA problem
    only: on the CPU (kernels on or plain, direct or implicit) it never
    calls ``_build.library``, and a whole CPU solve runs."""

    def refuse():
        raise AssertionError("_build.library called on the CPU")

    monkeypatch.setattr(_build, "library", refuse)
    p, _, _ = make_pinhole_ba(5, 30, 0.7, noise=1e-3, dtype=torch.float64, batched="cm",
                              device="cpu")
    for solver in ("schur", "schur_cg"):
        for plain in (False, True):
            comp = optimize.compile_problem(p, solver=solver, schur_family=pt.Euclidean(3),
                                            plain=plain)
            assert comp.schur_info.implicit == (solver == "schur_cg")
    r = pt.optimize(p, pt.Options(solver="schur", schur_family=pt.Euclidean(3), max_iters=2))
    assert r.num_iterations == 2 and np.isfinite(r.best_cost)
