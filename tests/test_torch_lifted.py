"""Kernels B1, B2 and B8 at shapes past the port's old caps (n ≤ 4, dr_s ≤
16, dl ≤ 6), on the CPU against the JAX package: their plain versions —
the CPU path and the card's yardstick — at (5, 6, 3) and (2, 6, 7) against
the JAX package's interpret-mode ``fused_obs_all_pm``, ``fused_obs_leg_pm``
and (over a two-bucket batch at (2, 6, 7)) ``fused_obs_all_pm_into``, on
the same numpy inputs made from a seed.  W is compared through the p-major
column map (standard column v·dr_s + p at p·NRp + v, as the JAX compile's
``pm_of_std`` maps it) and the camera side per camera, after B6's plain
version over the camera runs.  K ≤ 2 and one 128-lane tile; one jitted
JAX run (six interpret-mode calls) serves every check.

Tolerance: rtol 1e-12, atol 1e-13 in float64, as
``tests/test_torch_any_shape.py`` (the same arithmetic summed in another
order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nllstpu.ops.pallas.fused_obs import (fused_obs_all_pm, fused_obs_all_pm_into,
                                          fused_obs_leg_pm)
from nllstpu_torch.ops import fused_obs, segment_sum

TOL = dict(rtol=1e-12, atol=1e-13)

#: (n, dr_s, dl, e_start, K, L, n_r) of the tile cases: five residual rows
#: (the landmark first) and seven landmark dof (the landmark last).
TILES = {(5, 6, 3): (0, 2, 100, 9), (2, 6, 7): (6, 2, 120, 11)}
#: The two-bucket B2 case at (2, 6, 7): (K, landmarks) of each bucket.
BUCKETS = ((2, 40), (1, 70))
B2_SHAPE, B2_NR = (2, 6, 7, 6), 13


def _tile(rng, n, s, K, L, n_r):
    """One [K, L] tile: a camera repeated within each landmark (slot 1 =
    slot 0) and a dustbin slot (zero weights) on every third landmark."""
    jac = rng.standard_normal((n, s, K, L))
    g0 = rng.standard_normal((s, K, L))
    d1 = rng.random((K, L)) + 0.05
    d2 = -0.2 * rng.random((K, L))
    vc = rng.integers(0, n_r, (K, L)).astype(np.int32)
    if K > 1:
        vc[1] = vc[0]
    vc[K - 1, ::3] = n_r
    d1[K - 1, ::3] = 0.0
    d2[K - 1, ::3] = 0.0
    return jac, g0, d1, d2, vc


def _w_pm(w, n_r, dr_s):
    """The port's W [L, dl, n_r·dr_s] in the JAX kernels' p-major layout
    [dl, dr_s·NRp, L] (columns past n_r zero)."""
    L, dl, _ = w.shape
    nrp = -(-n_r // 128) * 128
    out = np.zeros((dl, dr_s * nrp, L))
    v, p = np.divmod(np.arange(n_r * dr_s), dr_s)
    out[:, p * nrp + v, :] = w.transpose(1, 2, 0)
    return out


def _jax_run(tiles, batch):
    """Every JAX kernel of the checks in one jitted run: B1 and B8 on each
    tile, then B2 over the buckets (``tests/test_torch_any_shape.py``'s
    loop: each bucket's columns as a [K, L_b] tile, h_ll/g_l added at the
    returned lane base, W carried through the p-major buffer, the camera
    blocks summed)."""
    out = {}
    for shape in TILES:
        jac, g0, d1, d2, vc = tiles[str(shape)]
        e_start, _, _, n_r = TILES[shape]
        _, dr_s, dl = shape
        args = (jac, g0, d1, d2, vc, n_r, dr_s, dl, e_start)
        out[str(shape)] = (fused_obs_all_pm(*args, interpret=True),
                           fused_obs_leg_pm(*args, interpret=True))
    jac, g0, d1, d2, vc = batch
    n, dr_s, dl, e_start = B2_SHAPE
    L = sum(lb for _, lb in BUCKETS)
    nrp = -(-B2_NR // 128) * 128
    h_ll, g_l = jnp.zeros((dl, dl, L)), jnp.zeros((dl, L))
    w, ab = jnp.zeros((dl, dr_s * nrp, L)), 0.0
    l0 = c0 = 0
    for kb, lb in BUCKETS:
        sl = slice(c0, c0 + lb * kb)
        tiles_b = (jac[:, :, sl].reshape(n, dr_s + dl, lb, kb).transpose(0, 1, 3, 2),
                   g0[:, sl].reshape(dr_s + dl, lb, kb).transpose(0, 2, 1),
                   d1[sl].reshape(lb, kb).T, d2[sl].reshape(lb, kb).T, vc[sl].reshape(lb, kb).T)
        h_add, g_add, w, ab_b, la = fused_obs_all_pm_into(*tiles_b, w, l0, B2_NR, dr_s, dl,
                                                          e_start, interpret=True)
        span = h_add.shape[-1]
        h_ll = h_ll.at[:, :, la:la + span].add(h_add)
        g_l = g_l.at[:, la:la + span].add(g_add)
        ab = ab + ab_b
        l0, c0 = l0 + lb, c0 + lb * kb
    out["b2"] = (h_ll, g_l, w, ab)
    return out


@pytest.fixture(scope="module")
def lifted():
    """The numpy inputs of every check and one JAX run over them."""
    rng = np.random.default_rng(19)
    tiles = {}
    for (n, dr_s, dl), (_, K, L, n_r) in TILES.items():
        tiles[(n, dr_s, dl)] = _tile(rng, n, dr_s + dl, K, L, n_r)
    n, dr_s, dl, _ = B2_SHAPE
    parts = [_tile(rng, n, dr_s + dl, kb, lb, B2_NR) for kb, lb in BUCKETS]
    # Each bucket's tile as landmark-run columns (slot k of landmark l at
    # l·K + k), the buckets one after the other.
    batch = tuple(
        np.concatenate([np.swapaxes(p[i], -1, -2).reshape(*p[i].shape[:-2], -1) for p in parts],
                       axis=-1)
        for i in range(5)
    )
    out = jax.jit(_jax_run)({str(k): tuple(jnp.asarray(a) for a in v) for k, v in tiles.items()},
                            tuple(jnp.asarray(a) for a in batch))
    return tiles, batch, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("kernel", ["B1", "B8"])
@pytest.mark.parametrize("shape", list(TILES))
def test_tile_plain_matches_pallas(lifted, shape, kernel):
    """B1's plain version (with B6's over its camera runs) or B8's at one
    lifted shape against the JAX package's interpret-mode kernel: h_ll, g_l,
    W and (B1) each camera's a_rr upper triangle and b_r."""
    tiles, _, jax_out = lifted
    n, dr_s, dl = shape
    e_start, _, _, n_r = TILES[shape]
    assert not (n <= 4 and dr_s <= 16 and dl <= 6)  # past the old caps
    assert fused_obs.kernel_takes(n, dr_s, dl, torch.float64)
    jac, g0, d1, d2, vc = (torch.as_tensor(a) for a in tiles[shape])
    if kernel == "B1":
        got = fused_obs.fused_obs_all(jac, g0, d1, d2, vc, *fused_obs.camera_tables(vc, n_r),
                                      n_r, dr_s, dl, e_start)
        ref = jax_out[str(shape)][0]
        ab = got[3].numpy()
        np.testing.assert_allclose(ab, ref[3][:, :n_r].T, err_msg="ab", **TOL)
        assert float(np.abs(ref[3]).max()) > 0
    else:
        got = fused_obs.fused_obs_leg(jac, g0, d1, d2, vc, n_r, dr_s, dl, e_start)
        ref = jax_out[str(shape)][1]
    for name, a, b in zip(("h_ll", "g_l"), got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)
    np.testing.assert_allclose(_w_pm(got[2].numpy(), n_r, dr_s), ref[2], err_msg="w", **TOL)
    assert float(np.abs(ref[2]).max()) > 0


def test_b2_plain_matches_pallas(monkeypatch, lifted):
    """B2's plain version at (2, 6, 7) over both buckets in one call
    (through its slot tables), then B6's over the camera runs, against the
    JAX package's interpret-mode B2 (one call per bucket)."""
    _, batch, jax_out = lifted
    n, dr_s, dl, e_start = B2_SHAPE
    L = sum(lb for _, lb in BUCKETS)
    lid = np.concatenate([l0 + np.repeat(np.arange(lb), kb) for (kb, lb), l0 in
                          zip(BUCKETS, np.cumsum([0] + [lb for _, lb in BUCKETS])[:-1])])
    vc = batch[4]
    cpos, cstarts = fused_obs.camera_order(vc, B2_NR)
    slots = fused_obs.SlotTables(*(torch.as_tensor(t) for t in
                                   fused_obs.slot_tables(lid, vc, L, B2_NR)))
    # The first bucket's repeated cameras (slot 1 = slot 0), but where slot
    # 1 is the dustbin.
    assert int((slots.slots < 0).sum()) == BUCKETS[0][1] - -(-BUCKETS[0][1] // 3)
    calls = []
    monkeypatch.setattr(fused_obs, "fused_obs_all_into_reference", functools.partial(
        lambda fn, *a: calls.append(1) or fn(*a), fused_obs.fused_obs_all_into_reference))
    h_ll, g_l, w, rows = fused_obs.zero_buffers(L, B2_NR, dr_s, dl, int(cstarts[-1]),
                                                torch.float64, "cpu")
    fused_obs.fused_obs_all_into(*(torch.as_tensor(a) for a in batch), torch.as_tensor(cpos),
                                 slots, h_ll, g_l, w, rows, B2_NR, dr_s, dl, e_start)
    assert calls == [1]
    ab = segment_sum.segment_block_sum(rows, torch.as_tensor(cstarts))
    h_j, g_j, w_j, ab_j = jax_out["b2"]
    np.testing.assert_allclose(h_ll.numpy(), h_j, err_msg="h_ll", **TOL)
    np.testing.assert_allclose(g_l.numpy(), g_j, err_msg="g_l", **TOL)
    np.testing.assert_allclose(_w_pm(w.numpy(), B2_NR, dr_s), w_j, err_msg="w", **TOL)
    np.testing.assert_allclose(ab.numpy(), ab_j[:, :B2_NR].T, err_msg="ab", **TOL)
    assert float(np.abs(w_j).max()) > 0 and float(np.abs(ab_j).max()) > 0
