"""The compile-time tables of kernels B2 and B5 and the plain versions that
read them, on the CPU in float64, without the JAX package (the dense twins
are held against the Pallas kernels in test_torch_ops.py,
test_torch_camera_side.py and test_torch_adaptive.py).

B2's tables give every landmark its real slots, from every degree bucket,
in one launch's work list, and mark each slot whose camera repeats an
earlier one of its landmark.  B5's (``schur_reduce.RowTables``, the
table type of B3 and B4 too) give every column-block pair i ≤ j the
landmarks that hold both.  Tolerances: 1e-12 of the largest entry (the
same float64 arithmetic, summed in another order).
"""

import numpy as np
import pytest
import torch

import nllstpu_torch as pt
from nllstpu_torch.core import optimize
from nllstpu_torch.core.problem import family_name
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.ops import fused_obs, schur, schur_reduce

#: ``make_realistic_bal`` arguments of a skewed problem whose plan starts
#: with a chunk bucket (as tests/test_torch_camera_side.py's).
CHUNK = ((80, 160), dict(seed=3, noise=1e-3, track_alpha=1.0, max_track=80))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


def _with_duplicates(data):
    """``data`` with three observations repeated (same point, camera and
    measurement): of the point with the longest track, which the chunk
    bucket holds, and of two single-digit tracks."""
    counts = np.bincount(data["pt_idx"])
    picks = [np.nonzero(data["pt_idx"] == np.argmax(counts))[0][5]]
    picks += list(np.nonzero(counts[data["pt_idx"]] == 3)[0][[0, 4]])
    out = dict(data)
    for key in ("cam_idx", "pt_idx", "observations"):
        out[key] = np.concatenate([data[key], data[key][picks]])
    return out, picks


@pytest.fixture(scope="module")
def skewed():
    """The chunk-bucket problem with repeated observations, compiled for
    the direct solve (kernel B2's tables) and for the implicit one."""
    (nc, npt), kw = CHUNK
    data, picks = _with_duplicates(tbal.make_realistic_bal(nc, npt, **kw))
    out = {}
    for solver in ("schur", "schur_cg"):
        p, _, pts = tbal.make_bal_problem(data, dtype=torch.float64, device="cpu")
        perturb_ba(p, pts, 0.05, seed=5)
        out[solver] = (p, optimize.compile_problem(p, solver=solver, schur_family=tbal.PT))
    return data, picks, out


def test_b2_tables_cover_each_landmark_once(skewed):
    """Each landmark's slots are its real columns in column order, from the
    chunk bucket and its class bucket together; a slot is marked (``~col``)
    exactly when its camera repeats an earlier one of its landmark, the
    injected repeats among them; the work list takes every landmark with
    slots once, in items of consecutive landmarks of one lane group."""
    data, picks, out = skewed
    p, comp = out["schur"]
    info = comp.schur_info
    (batch,), (fast,) = comp.batches, info.fast
    assert len(fast.buckets) == 7 and fast.buckets[0][3] == 0  # a chunk bucket leads
    L, n_r = info.num_elim, fast.n_r
    slots, starts, work = (t.numpy() for t in fast.slots)
    lid = info.elim_ids[info.elim_family][batch.idx[fast.e_slot].numpy()]
    lid = np.where(batch.mask.numpy(), lid, L)
    assert np.array_equal(np.diff(starts), np.bincount(lid[lid < L], minlength=L))
    cols = np.where(slots < 0, ~slots, slots)
    seen_pairs = 0
    for l in range(L):
        mine = cols[starts[l] : starts[l + 1]]
        assert np.array_equal(mine, np.nonzero(lid == l)[0])
        cams = fast.rvid[mine]
        first = {}
        for c, v, s in zip(mine, cams, slots[starts[l] : starts[l + 1]]):
            repeat = v < n_r and v in first
            assert (s < 0) == repeat, (l, c, v)
            first.setdefault(v, c)
        seen_pairs += len([v for v in first if v < n_r])
    # Three injected repeats (and the generator's own: tracks are camera
    # windows, so none there).
    assert int((slots < 0).sum()) == 3
    heavy = int(np.argmax(np.diff(starts)))
    assert np.diff(starts)[heavy] > 64 and (slots[starts[heavy] : starts[heavy + 1]] < 0).any()
    # The work list: every landmark with slots once, in items of one group.
    counts = np.diff(starts)
    covered = np.zeros(L, dtype=int)
    for first_l, n_l, lg2 in work:
        ls = np.arange(first_l, first_l + n_l)
        covered[ls] += 1
        g = 1 << lg2
        assert 1 <= n_l <= fused_obs.GROUP_MAX // g
        assert np.all(np.minimum(counts[ls], 32) <= g) and np.all(counts[ls] > g // 2)
    assert np.array_equal(covered, (counts > 0).astype(int))
    assert seen_pairs == len({(a, b) for a, b in zip(data["pt_idx"], data["cam_idx"])})


def test_bucketed_assembly_matches_implicit_blocks(skewed):
    """The direct assembly of the skewed problem with repeated observations
    (B2's plain version over its tables, then B6's over the camera runs)
    against the implicit backend's keyed sums of the same per-cost blocks,
    W formed densely from its per-cost coupling blocks."""
    _, _, out = skewed
    (p, comp), (_, comp_cg) = out["schur"], out["schur_cg"]
    v = p.stacked_variables()
    cost, (a_rr, b_r, h_ll, g_l, w) = comp.assemble(v)
    cost_cg, (a2, b2, h2, g2, wparts) = comp_cg.assemble(v)
    L, dl = comp.schur_info.num_elim, comp.schur_info.dof_elim
    dr = comp.schur_info.dim_reduced
    dense = torch.zeros(L + 1, dl, dr + 1, dtype=torch.float64)
    for wp in wparts:
        blk = wp.w_blk.transpose(1, 2)  # [B, dl, dr_s]
        lid = wp.lid[:, None, None].expand_as(blk)
        d = torch.arange(dl)[None, :, None].expand_as(blk)
        col = wp.rows_r[:, None, :].expand_as(blk)
        dense.index_put_((lid, d, col), blk, accumulate=True)
    np.testing.assert_allclose(float(cost), float(cost_cg), rtol=1e-13)
    for got, ref in ((a_rr, a2), (b_r, b2), (h_ll, h2), (g_l, g2), (w, dense[:L, :, :dr])):
        _close(got.numpy(), ref.numpy())


def _structured(rng, L, dl, widths, spare):
    """A W zero outside a random block structure (landmark 0 holds none,
    landmark 1 only the last block, as a landmark seen by the kernel
    alone), its inverses and g_l, and its block tables."""
    widths = np.asarray(widths)
    bcol = np.cumsum(widths + rng.integers(0, spare + 1, widths.shape[0])) - widths
    held = rng.random((L, widths.shape[0])) < 0.4
    held[0] = False
    held[1] = False
    held[1, -1] = True
    lmk, blk = np.nonzero(held)
    w = np.zeros((L, dl, int(bcol[-1] + widths[-1] + spare)))
    for l, b in zip(lmk, blk):
        w[l, :, bcol[b] : bcol[b] + widths[b]] = rng.standard_normal((dl, widths[b]))
    a = rng.standard_normal((L, dl, dl))
    h_inv = np.linalg.inv(a @ a.transpose(0, 2, 1) + 2.0 * np.eye(dl)).transpose(1, 2, 0)
    g = rng.standard_normal((dl, L))
    # Every incidence listed twice: repeats are ignored.
    tables = schur_reduce.row_tables(np.tile(lmk, 2), np.tile(blk, 2), L, bcol, widths)
    return [torch.from_numpy(np.ascontiguousarray(t)) for t in (w, h_inv, g)], tables


@pytest.mark.parametrize("dl,widths,spare", [
    (3, [9] * 12 + [3], 0), (5, [4, 16, 1, 9, 7], 3), (1, [1, 2, 3], 2), (6, [6] * 9, 1),
])
def test_pair_mirror_matches_dense(dl, widths, spare):
    """B5's plain mirror over the block tables equals the dense plain
    version on a W zero outside the structure, an empty landmark and a
    kernel-only landmark included; every block pair is listed, its links
    hold its landmarks once, in order, in items of at most LINK_CHUNK."""
    rng = np.random.default_rng(dl)
    (w, h_inv, g), t = _structured(rng, 200, dl, widths, spare)
    ref = schur_reduce.reduce_s_reference(w, h_inv, g)
    got = schur_reduce.reduce_s_rows_reference(w, h_inv, g, t)
    _close(got[0].numpy(), ref[0].numpy())
    _close(got[1].numpy(), ref[1].numpy())
    assert t.covered == sum(widths) and (t.covered < w.shape[2]) == (spare > 0)
    nb = len(widths)
    assert t.pairs.tolist() == [[i, j] for i in range(nb) for j in range(i, nb)]
    assert t.blk[t.lmk == 0].tolist() == [-1] and t.blk[t.lmk == 1].tolist() == [nb - 1]
    lmk_i, blk_i, blk_j = t.lmk[t.links[:, 0]], t.blk[t.links[:, 0]], t.blk[t.links[:, 1]]
    assert np.all(t.lmk[t.links[:, 1]] == lmk_i) and np.all(blk_i <= blk_j)
    last = t.pairs.tolist().index([nb - 1] * 2)
    for p in range(t.pairs.shape[0]):
        its = t.items[t.istarts[p] : t.istarts[p + 1]]
        if p == last:
            assert 1 in lmk_i[its[0, 1] : its[-1, 2]]
        if len(its) == 0:
            continue
        run = slice(its[0, 1], its[-1, 2])
        assert np.all(np.diff(lmk_i[run]) > 0)
        assert np.all(blk_i[run] == t.pairs[p, 0]) and np.all(blk_j[run] == t.pairs[p, 1])
        assert np.all(its[:, 0] == p)
        assert np.all(its[1:, 1] == its[:-1, 2]) and np.all(its[:, 2] - its[:, 1] <= schur_reduce.LINK_CHUNK)


@pytest.fixture(scope="module")
def adaptive():
    """A small adaptive BAL problem compiled for the direct solve."""
    data = tbal.make_realistic_bal(12, 300, seed=2, noise=1e-3, track_alpha=1.6)
    p, _, pts, kh = tbal.make_bal_problem(
        data, dtype=torch.float64, device="cpu", kernel=pt.ContaminatedGaussian(),
        kernel_params=pt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8),
    )
    perturb_ba(p, pts, 0.01, seed=5)
    return data, p, kh, optimize.compile_problem(p, solver="schur", schur_family=tbal.PT)


def test_adaptive_pair_tables(adaptive):
    """On the adaptive problem: every (landmark, block i ≤ j) of the
    landmark's blocks (its cameras', then the kernel's) appears exactly
    once, landmarks ascending within a pair, and the kernel block pairs
    with every camera; SchurOps gets the tables and counts their build in
    the compile."""
    data, p, kh, comp = adaptive
    info, layout = comp.schur_info, comp.layout
    t = info.w_pairs
    assert info.w_rows is None
    bcol, bwidth = t.bcol.numpy(), t.bwidth.numpy()
    cam_off = np.asarray(layout.offsets[family_name(tbal.CAM)])
    k_off = int(np.asarray(layout.offsets[family_name(kh.manifold)])[kh.index])
    lid = info.elim_ids[info.elim_family][data["pt_idx"]]
    blocks = {}
    for l, c in zip(lid, data["cam_idx"]):
        blocks.setdefault(int(l), set()).add(int(cam_off[c]))
    for l in blocks:
        blocks[l].add(k_off)
    expect = sorted(
        (int(np.searchsorted(bcol, a)), int(np.searchsorted(bcol, b)), l)
        for l, cols in blocks.items() for a in cols for b in cols if a <= b
    )
    pairs, items, istarts = t.pairs.numpy(), t.items.numpy(), t.istarts.numpy()
    lmk, blk, links = t.lmk.numpy(), t.blk.numpy(), t.links.numpy()
    got, runs = [], []
    for q in range(pairs.shape[0]):
        its = items[istarts[q] : istarts[q + 1]]
        run = links[its[0, 1] : its[-1, 2]] if len(its) else links[:0]
        assert np.all(blk[run[:, 0]] == pairs[q, 0]) and np.all(blk[run[:, 1]] == pairs[q, 1])
        got += [(int(pairs[q, 0]), int(pairs[q, 1]), int(lmk[s])) for s in run[:, 0]]
        runs.append(lmk[run[:, 0]])
    assert sorted(got) == expect
    assert all(np.all(np.diff(r) > 0) for r in runs)
    kb = int(np.searchsorted(bcol, k_off))
    assert bwidth[kb] == kh.manifold.dof and np.all(np.delete(bwidth, kb) == 9)
    assert {i for (i, j, _) in got if j == kb} | {j for (i, j, _) in got if i == kb} == set(
        range(len(bcol)))
    assert info.table_seconds > 0
    ops = comp.ctx().linops
    assert ops.pairs is t and ops.rows is None


def test_adaptive_w_lies_in_its_structure(adaptive):
    """The adaptive assembly's W is zero outside the blocks its tables give
    each landmark: the body's plain mirror over them equals the dense plain
    version on that W."""
    _, p, _, comp = adaptive
    _, (_, _, h_ll, g_l, w) = comp.assemble(p.stacked_variables())
    lam = 1e-2 * float(torch.diagonal(h_ll, dim1=0, dim2=1).abs().max())
    h_inv = schur.SchurOps.damped_inverse(h_ll, lam)
    ref = schur_reduce.reduce_s_reference(w, h_inv, g_l)
    got = schur_reduce.reduce_s_rows_reference(w, h_inv, g_l, comp.schur_info.w_pairs)
    _close(got[0].numpy(), ref[0].numpy())
    _close(got[1].numpy(), ref[1].numpy())
