"""The stereo path's assembly kernel, B2 at (3, 9, 3), on the CPU against
the JAX package, and the host's plan of the any-shape instance's shared
memory.

B2's plain version over a degree-bucketed stereo batch — every bucket at
once through its slot tables — then B6's over the camera runs, is held to
the JAX package's interpret-mode ``fused_obs_all_pm_into`` (its
``NLLSTPU_W_IMPL=fused_all_interpret`` route), one call per bucket as the
JAX assembly makes them, on the same inputs: the port's weighted Jacobian,
g0, ρ′ and 2ρ″ of the stereo problem (``scripts_torch/shapes_reference.py``
on a cut ``make_realistic_bal`` pattern), W compared through the JAX
compile's ``pm_of_std``, as ``tests/test_torch_shapes.py::
test_dl2_system_matches_pallas`` does for the planar path's B1.  The same
inputs, because the two packages' jitted residuals differ in their last
bits (predictions of hundreds of pixels), which g0 = Jᵀr multiplies into
b_r and g_l.  Tolerance: rtol 1e-12, atol 1e-13 in float64 (the same
arithmetic summed in another order).  One JAX run (two buckets, each
interpret-mode compile ~3–12 s) serves every comparison.

``fused_obs.any_shape_plan`` mirrors the CUDA source's ``any_bytes`` and
``any_warps`` (``tests/test_torch_cuda.py::
test_any_shape_plan_matches_the_source`` holds them equal on the card);
here its properties the kernel and the route rely on."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nllstpu as nt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.ops.pallas.fused_obs import fused_obs_all_pm_into
import nllstpu_torch as pt
from nllstpu_torch.models.bal import make_realistic_bal
from nllstpu_torch.ops import fused_obs, schur, segment_sum
from scripts_torch import shapes_reference as sr

TOL = dict(rtol=1e-12, atol=1e-13)

#: Bytes of shared memory a block can opt in to on the H100 (227 KB).
SMEM_OPT_IN = 232_448


def _stereo_data(heavy=4, light=36):
    """Stereo data over ``make_realistic_bal(12, 300, seed=1)``'s pattern
    cut to a skewed one: ``heavy`` points keep 4 of their observations and
    ``light`` points one, so that the layout takes two degree buckets (K =
    4 and 1) and B2 their slot tables."""
    base = make_realistic_bal(12, 300, seed=1, noise=1e-3)
    pt_idx = base["pt_idx"]
    counts = np.bincount(pt_idx)
    pts = np.concatenate([np.nonzero(counts >= 4)[0][:heavy],
                          np.nonzero(counts < 4)[0][:light]])
    rows = np.concatenate([np.nonzero(pt_idx == p)[0][: 4 if i < heavy else 1]
                           for i, p in enumerate(pts)])
    new_id = np.full(counts.shape[0], -1)
    new_id[pts] = np.arange(pts.shape[0])
    return sr.stereo_data(dict(
        cameras=base["cameras"], points=base["points"][pts],
        cam_idx=base["cam_idx"][rows], pt_idx=new_id[pt_idx[rows]].astype(np.int32),
        observations=base["observations"][rows]))


def _jax_b2(jac, g0, d1m, d2m, vc, *, buckets, L, n_r, nrp, dr_s, dl, e_start):
    """The JAX package's fused_all assembly loop (``ops/schur.py``): each
    bucket's columns as a [K, L_b] tile through interpret-mode
    ``fused_obs_all_pm_into``, its h_ll/g_l added at the returned lane base,
    W carried through the p-major buffer, the camera blocks summed."""
    nres, stot = jac.shape[:2]
    h_ll, g_l = jnp.zeros((dl, dl, L)), jnp.zeros((dl, L))
    w, ab = jnp.zeros((dl, dr_s * nrp, L)), 0.0
    for l0, lb, kb, c0 in buckets:
        sl = slice(c0, c0 + lb * kb)
        tiles = (jac[:, :, sl].reshape(nres, stot, lb, kb).transpose(0, 1, 3, 2),
                 g0[:, sl].reshape(stot, lb, kb).transpose(0, 2, 1),
                 d1m[sl].reshape(lb, kb).T, d2m[sl].reshape(lb, kb).T, vc[sl].reshape(lb, kb).T)
        h_add, g_add, w, ab_b, la = fused_obs_all_pm_into(*tiles, w, l0, n_r, dr_s, dl, e_start,
                                                          interpret=True)
        span = h_add.shape[-1]
        h_ll = h_ll.at[:, :, la:la + span].add(h_add)
        g_l = g_l.at[:, la:la + span].add(g_add)
        ab = ab + ab_b
    return h_ll, g_l, w, ab


@pytest.fixture(scope="module")
def stereo_b2():
    """The port's stereo batch in float64 (compile, B2's inputs and bucket
    plan) and one JAX run of the JAX package's B2 over the same inputs."""
    tp = sr.build(pt, "stereo", _stereo_data(), torch.float64, "cpu")[0]
    comp = pt.compile_problem(tp, solver="schur", schur_family=pt.Euclidean(3))
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, head, tail = schur.batch_inputs(batch, tp.stacked_variables(), comp.schur_info, fast,
                                       torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NLLSTPU_W_IMPL", "fused_all_interpret")
        jp = sr.build(nt, "stereo", _stereo_data(), jnp.float64)[0]
        jinfo = jax_compile(jp, solver="schur", schur_family=nt.Euclidean(3)).schur_info
    assert jinfo.w_pm is not None and tuple(jinfo.fast[0].buckets) == tuple(fast.buckets)
    n_r, dr_s, dl, e_start = tail
    run = jax.jit(functools.partial(_jax_b2, buckets=tuple(fast.buckets), L=jinfo.num_elim,
                                    n_r=n_r, nrp=jinfo.w_pm[1], dr_s=dr_s, dl=dl,
                                    e_start=e_start))
    out = run(*(jnp.asarray(t.numpy()) for t in head[:5]))
    return comp, fast, head, tail, [np.asarray(t) for t in out], jinfo.w_pm[3]


def test_stereo_b2_matches_pallas(monkeypatch, stereo_b2):
    """B2's plain version at (3, 9, 3) over both buckets in one call, then
    B6's over the camera runs, against the JAX package's interpret-mode B2
    (one call per bucket) on the same inputs: h_ll, g_l, W and each
    camera's a_rr upper triangle and b_r."""
    comp, fast, head, tail, (h_j, g_j, w_j, ab_j), pm_of_std = stereo_b2
    assert isinstance(fast, schur._FastBatch) and fast.slots is not None
    assert (head[0].shape[0], tail[1], tail[2]) == (3, 9, 3)
    assert [b[2] for b in fast.buckets] == [4, 1]
    counts = {}

    def counting(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_obs, "fused_obs_all_into_reference",
                        counting(fused_obs.fused_obs_all_into_reference))
    monkeypatch.setattr(segment_sum, "segment_block_sum_reference",
                        counting(segment_sum.segment_block_sum_reference))
    n_r, dr_s, dl, _ = tail
    L = comp.schur_info.num_elim
    h_ll, g_l, w, rows = fused_obs.zero_buffers(L, n_r, dr_s, dl, int(fast.cam_starts[-1]),
                                                torch.float64, "cpu")
    fused_obs.fused_obs_all_into(*head, h_ll, g_l, w, rows, *tail)
    ab = segment_sum.segment_block_sum(rows, fast.cstarts)
    assert counts == {"fused_obs_all_into_reference": 1, "segment_block_sum_reference": 1}
    np.testing.assert_allclose(h_ll.numpy(), h_j[:, :, :L], err_msg="h_ll", **TOL)
    np.testing.assert_allclose(g_l.numpy(), g_j[:, :L], err_msg="g_l", **TOL)
    np.testing.assert_allclose(w.permute(1, 0, 2).numpy(),
                               w_j.transpose(0, 2, 1)[:, :L, pm_of_std], err_msg="w", **TOL)
    np.testing.assert_allclose(ab.numpy(), ab_j[: ab.shape[1], :n_r].T, err_msg="ab", **TOL)
    assert float(np.abs(h_j).max()) > 0 and float(np.abs(ab_j).max()) > 0


def test_any_shape_plan():
    """The plan at two shapes worked by hand; over a sweep of shapes (the
    old caps' and NRSfM's among them): a staged slot of an odd number of
    values holding the n·S Jacobian columns, g0, ρ′ and 2ρ″; a chunk of at
    most 32 h_ll/g_l entries; 8-byte aligned warp regions; up to four warps
    a block within the 227 KB a block opts in to, and ``kernel_takes``
    exactly where one warp fits."""
    assert fused_obs.SMEM_LIMIT == SMEM_OPT_IN
    # (2, 6, 2) float32: a slot 2·8 + 8 + 2 = 26 → 27 values; 3 h_ll and 2
    # g_l entries a chunk; a warp 32·(27 + 5)·4 + 32·24 bytes; four warps.
    assert fused_obs.any_shape_plan(2, 6, 2, torch.float32) == (27, 5, 4864, 4, 4 * 4864)
    # (2, 6, 18) float64 (NRSfM K = 6): 2·24 + 24 + 2 = 74 → 75 values;
    # 189 entries, chunks of 32; 32·(75 + 32)·8 + 768 = 28,160 bytes.
    assert fused_obs.any_shape_plan(2, 6, 18, torch.float64) == (75, 32, 28160, 4, 4 * 28160)
    for n in (1, 2, 3, 4, 5, 8, 21):
        for dr_s in (1, 6, 9, 16, 17, 40):
            for dl in (1, 2, 3, 6, 7, 9, 18, 33, 100, 300):
                s = dr_s + dl
                for dt in (torch.float32, torch.float64):
                    plan = fused_obs.any_shape_plan(n, dr_s, dl, dt)
                    assert plan.stride % 2 == 1 and n * s + s + 2 <= plan.stride <= n * s + s + 3
                    assert plan.chunk == min(dl * (dl + 1) // 2 + dl, 32)
                    assert plan.warp_bytes % 8 == 0
                    assert plan.warps == min(4, SMEM_OPT_IN // plan.warp_bytes)
                    assert plan.block_bytes == plan.warps * plan.warp_bytes <= SMEM_OPT_IN
                    assert fused_obs.kernel_takes(n, dr_s, dl, dt) == (
                        plan.warp_bytes <= SMEM_OPT_IN)
    assert not fused_obs.kernel_takes(2, 6, 3, torch.float16)
