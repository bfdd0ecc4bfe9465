"""The port's CUDA kernels (B1–B8) against their plain
PyTorch versions, on the card.  These tests skip without a CUDA device.  This file
imports neither jax nor the JAX package, so on a machine with a card and no
jax it runs with ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: in float64 the kernels differ from the plain versions only by
summation order (1e-12 of the largest entry).  In float32, B1's and B2's
per-camera sums (kernel B6 over the camera runs of their per-slot rows)
run over hundreds of terms and B3 sums over L·dl terms in another order
than the float64 yardstick: all are held to 1e-5 of the largest entry.
B6 sums each run in a fixed order: 1e-12 (float64) and 1e-5 (float32) of
the largest entry against the float64 plain version, and in float64 the
same bits as its plain mirror of the chunk order.  B3 and B4 reduce over
an obs-major W's camera blocks (B4 over external inverses), B5 over W's
column-block structure, a landmark's few products per entry summed in
landmark order: held as B3 was, against the dense plain version, and
s_sum exactly symmetric.  B7 adds a few values per
entry in run order: 1e-12 (float64) and 1e-6 (float32) of the largest
entry.  No kernel uses atomics: each gives the same bits on a second
launch.
"""

import numpy as np
import pytest
import torch

from nllstpu_torch.ops import _build, fused_obs, schur_reduce, segment_sum, w_place


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(a, b):
    b64 = b.double()
    return float((a.double() - b64).abs().max() / b64.abs().max().clamp_min(1e-300))


def _b1_inputs(gen, K, L, n_r, dr_s, device, dtype, n=2, dl=3):
    s = dr_s + dl
    jac = torch.randn(n, s, K, L, generator=gen, dtype=torch.float64)
    g0 = torch.randn(s, K, L, generator=gen, dtype=torch.float64)
    d1 = torch.rand(K, L, generator=gen, dtype=torch.float64) + 0.05
    d2 = -0.2 * torch.rand(K, L, generator=gen, dtype=torch.float64)
    vc = torch.randint(0, n_r, (K, L), generator=gen, dtype=torch.int32)
    vc[1] = vc[0]
    pad = torch.zeros(K, L, dtype=torch.bool)
    pad[K - 1, ::3] = True
    vc[pad] = n_r
    d1[pad] = 0.0
    d2[pad] = 0.0
    return [t.to(device=device, dtype=dtype) for t in (jac, g0, d1, d2)] + [vc.to(device)]


#: (n, dr_s, dl, e_start, n_r) of the B1, B2 and B8 cases: the unrolled
#: instances' pinhole camera before and after the landmark and Snavely
#: camera (n_r = 300: many short camera runs, ~47 slots each); the
#: any-shape instance at a planar landmark (2, 6, 2), three residual rows
#: (3, 6, 3) and (3, 9, 3), at the old caps (4, 16, 6), and at shapes whose
#: entry lists end mid-warp: one row and one landmark dof (1, 7, 1), the
#: landmark first at (4, 13, 5), the landmark last at (3, 16, 6); past the
#: old caps n ≤ 4, dr_s ≤ 16, dl ≤ 6: NRSfM's (2, 6, 9) and (2, 6, 18)
#: (h_ll/g_l in chunks of 32 entries, W columns in pieces of 6 rows), five
#: rows (5, 6, 3) and a camera of 17 dof (2, 17, 3).
LIFTED = [(2, 6, 9, 6, 37), (2, 6, 18, 6, 37), (5, 6, 3, 0, 37), (2, 17, 3, 17, 23)]
ASM_SHAPES = [(2, 6, 3, 6, 37), (2, 6, 3, 0, 37), (2, 9, 3, 9, 300), (2, 6, 2, 6, 37),
              (3, 6, 3, 0, 37), (3, 9, 3, 9, 300), (4, 16, 6, 16, 23), (1, 7, 1, 7, 37),
              (4, 13, 5, 0, 23), (3, 16, 6, 16, 19), *LIFTED]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,dr_s,dl,e_start,n_r", ASM_SHAPES)
def test_fused_obs_kernel_matches_plain(cuda, dtype, tol, n, dr_s, dl, e_start, n_r):
    gen = torch.Generator().manual_seed(11)
    inputs = _b1_inputs(gen, 14, 1000, n_r, dr_s, cuda, dtype, n, dl)
    inputs += fused_obs.camera_tables(inputs[4], n_r)
    before, before_b6 = fused_obs.LAUNCHES, segment_sum.LAUNCHES
    out = fused_obs.fused_obs_all(*inputs, n_r, dr_s, dl, e_start)
    torch.cuda.synchronize()
    assert fused_obs.LAUNCHES == before + 1 and segment_sum.LAUNCHES == before_b6 + 1
    ref = fused_obs.fused_obs_all_reference(
        *[t.double() if t.is_floating_point() else t for t in inputs],
        n_r, dr_s, dl, e_start,
    )
    for name, a, b in zip(("h_ll", "g_l", "w", "ab"), out, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    again = fused_obs.fused_obs_all(*inputs, n_r, dr_s, dl, e_start)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,dr_s,dl,e_start,n_r", ASM_SHAPES)
def test_fused_obs_leg_kernel_matches_plain(cuda, dtype, tol, n, dr_s, dl, e_start, n_r):
    gen = torch.Generator().manual_seed(13)
    inputs = _b1_inputs(gen, 14, 1000, n_r, dr_s, cuda, dtype, n, dl)
    before, before_b1 = fused_obs.LEG_LAUNCHES, fused_obs.LAUNCHES
    out = fused_obs.fused_obs_leg(*inputs, n_r, dr_s, dl, e_start)
    torch.cuda.synchronize()
    assert fused_obs.LEG_LAUNCHES == before + 1 and fused_obs.LAUNCHES == before_b1
    ref = fused_obs.fused_obs_leg_reference(
        *[t.double() if t.is_floating_point() else t for t in inputs],
        n_r, dr_s, dl, e_start,
    )
    for name, a, b in zip(("h_ll", "g_l", "w"), out, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    again = fused_obs.fused_obs_leg(*inputs, n_r, dr_s, dl, e_start)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,dr_s,dl,e_start", [(2, 6, 2, 2), (3, 9, 3, 3), (2, 6, 18, 6),
                                               (5, 6, 3, 0)])
def test_fused_obs_any_shape_past_one_group(cuda, dtype, tol, n, dr_s, dl, e_start):
    """B1 and B8's any-shape instance at K = 40 (two rounds of a warp, every
    W block added into the zeroed rows, not found by __match_any_sync; h_ll
    and g_l stored on the first round and added on the second), a camera
    repeated across the rounds."""
    gen = torch.Generator().manual_seed(19)
    n_r = 31
    inputs = _b1_inputs(gen, 40, 300, n_r, dr_s, cuda, dtype, n, dl)
    inputs[4][35] = inputs[4][2]
    tables = fused_obs.camera_tables(inputs[4], n_r)
    out = fused_obs.fused_obs_all(*inputs, *tables, n_r, dr_s, dl, e_start)
    leg = fused_obs.fused_obs_leg(*inputs, n_r, dr_s, dl, e_start)
    ref = fused_obs.fused_obs_all_reference(
        *[t.double() if t.is_floating_point() else t for t in inputs], *tables,
        n_r, dr_s, dl, e_start,
    )
    for name, a, b in zip(("h_ll", "g_l", "w", "ab"), out, ref):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    for name, a, b in zip(("h_ll", "g_l", "w"), leg, ref):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("k", [14, 40])
def test_fused_obs_kernels_on_landmark_major_views(cuda, dtype, tol, k):
    """B1 and B8 on the main path's layout: [K, L] views of a
    landmark-major batch (no copy; g0 slot-major, as the einsum that
    forms it leaves it), at K = 14 (one lane group per landmark) and K =
    40 (two rounds of a warp, every W block added), each landmark seeing a
    camera twice; the same bits on a second launch."""
    gen = torch.Generator().manual_seed(17 + k)
    n_r, dr_s, L = 53, 9, 700
    tiles = _b1_inputs(gen, k, L, n_r, dr_s, "cpu", torch.float64)
    views = [
        t.transpose(-1, -2).contiguous().to(cuda).transpose(-1, -2) for t in tiles
    ]
    views[1] = tiles[1].permute(2, 1, 0).contiguous().to(cuda).permute(2, 1, 0)
    views = [t.to(dtype) if t.is_floating_point() else t for t in views]
    assert views[0].stride()[2:] == (1, k) and views[1].stride() == (1, 9 + 3, (9 + 3) * k)
    tables = fused_obs.camera_tables(views[4], n_r)
    cpos = tables[0].T.contiguous().T  # the same strides as the views
    out = fused_obs.fused_obs_all(*views, cpos, tables[1], n_r, dr_s, 3, 9)
    leg = fused_obs.fused_obs_leg(*views, n_r, dr_s, 3, 9)
    torch.cuda.synchronize()
    ref = fused_obs.fused_obs_all_reference(*tiles, *(t.cpu() for t in tables), n_r, dr_s, 3, 9)
    for name, a, b in zip(("h_ll", "g_l", "w", "ab"), out, ref):
        assert _rel_err(a.cpu(), b) <= tol, (name, _rel_err(a.cpu(), b))
    for name, a, b in zip(("h_ll", "g_l", "w"), leg, ref):
        assert _rel_err(a.cpu(), b) <= tol, (name, _rel_err(a.cpu(), b))
    assert all(torch.equal(a, b) for a, b in zip(
        out, fused_obs.fused_obs_all(*views, cpos, tables[1], n_r, dr_s, 3, 9)))
    assert all(torch.equal(a, b) for a, b in zip(
        leg, fused_obs.fused_obs_leg(*views, n_r, dr_s, 3, 9)))


def _tiles_as_batch(inputs, calls, l_total, n_r, device):
    """The calls' K-major tiles as one batch, call by call and landmark by
    landmark (slot k of the call's landmark l at column c0 + l·K + k), with
    kernel B2's tables and the camera order over it: ``[jac, g0, d1, d2,
    vc, cpos], slots, cstarts`` on ``device``."""
    cat = torch.cat
    batch = [
        cat([x[0].transpose(2, 3).reshape(*x[0].shape[:2], -1) for x in inputs], dim=2),
        # g0 slot-major, as the einsum that forms it on the main path.
        cat([x[1].transpose(1, 2).reshape(x[1].shape[0], -1) for x in inputs], dim=1).T
        .contiguous().T,
        *(cat([x[i].T.reshape(-1) for x in inputs]) for i in (2, 3, 4)),
    ]
    lid = np.concatenate([l_base + np.repeat(np.arange(lb), K) for K, l_base, lb in calls])
    vc = batch[4].cpu().numpy()
    cpos, cstarts = fused_obs.camera_order(vc, n_r)
    slots = fused_obs.slot_tables(lid, vc, l_total, n_r)
    return (batch + [torch.as_tensor(cpos, device=device)],
            fused_obs.SlotTables(*(torch.as_tensor(t, device=device) for t in slots)),
            torch.as_tensor(cstarts, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize(
    "n,dr_s,dl,e_start,n_r",
    # n_r = 300 at dr_s = 9: many short camera runs; the any-shape instance
    # at (2, 6, 2), (3, 6, 3), (3, 9, 3), the old caps (4, 16, 6) and the
    # lifted shapes.
    [(2, 9, 3, 9, 37), (2, 6, 3, 0, 37), (2, 9, 3, 9, 300), (2, 6, 2, 6, 37),
     (3, 6, 3, 0, 37), (3, 9, 3, 9, 300), (4, 16, 6, 16, 23), *LIFTED],
)
def test_fused_obs_into_kernel_matches_plain(cuda, dtype, tol, n, dr_s, dl, e_start, n_r):
    """B2 over one batch laid out as a degree-bucketed plan: a chunk bucket
    over the heavy prefix, the class bucket that covers it again, a class
    bucket at an unaligned l_base, and a 64-slot bucket of one landmark
    (two rounds of a warp, a camera repeated across them); every run sees a
    camera twice.  h_ll and g_l start non-zero and are added to; W starts
    zero; B6 sums the camera rows.  Twice: the same bits."""
    gen = torch.Generator().manual_seed(13)
    L = 1000
    calls = [(16, 0, 57), (14, 0, 300), (4, 337, 600), (64, 999, 1)]  # (K, l_base, L_b)
    init = [
        torch.randn(shape, generator=gen, dtype=torch.float64)
        for shape in ((dl, dl, L), (dl, L))
    ]
    init[0] = init[0] + init[0].transpose(0, 1)
    inputs = [_b1_inputs(gen, K, lb, n_r, dr_s, cuda, dtype, n, dl) for K, _, lb in calls]
    inputs[3][4][40] = inputs[3][4][3]
    batch, slots, cstarts = _tiles_as_batch(inputs, calls, L, n_r, cuda)
    assert int((slots.slots < 0).sum()) >= 957  # the repeats
    n_rows, nab = int(cstarts[-1]), dr_s * (dr_s + 3) // 2

    def assemble(kernel, dt):
        bufs = [t.to(device=cuda, dtype=dt) for t in init]
        w = torch.zeros(L, dl, n_r * dr_s, dtype=dt, device=cuda)
        rows = torch.zeros(n_rows, nab, dtype=dt, device=cuda)
        x = [t.to(dt) if t.is_floating_point() else t for t in batch]
        kernel(*x, slots, *bufs, w, rows, n_r, dr_s, dl, e_start)
        return bufs + [w, segment_sum.segment_block_sum(rows, cstarts)]

    before, before_b1 = fused_obs.INTO_LAUNCHES, fused_obs.LAUNCHES
    got = assemble(fused_obs.fused_obs_all_into, dtype)
    torch.cuda.synchronize()
    assert fused_obs.INTO_LAUNCHES == before + 1
    assert fused_obs.LAUNCHES == before_b1
    ref = assemble(fused_obs.fused_obs_all_into_reference, torch.float64)
    for name, a, b in zip(("h_ll", "g_l", "w", "ab"), got, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    for name, b, c in zip(("h_ll", "g_l"), ref, init):
        assert _rel_err(b, c.to(cuda)) > 1e-3, name  # every buffer was added to
    again = assemble(fused_obs.fused_obs_all_into, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,dr_s,dl,e_start", [(2, 6, 2, 6), (3, 9, 3, 9), (4, 16, 6, 0),
                                               (2, 6, 18, 6), (5, 6, 3, 0), (2, 17, 3, 17)])
def test_fused_obs_into_repeats_across_rounds(cuda, dtype, tol, n, dr_s, dl, e_start):
    """B2's any-shape instance over landmarks of 70 and 45 slots (three and
    two rounds of a warp) among 11 cameras: every landmark repeats cameras
    within a round and across rounds (the table's ~column marks), so each
    W block is stored by its first slot and added to after, in slot order;
    the same bits on a second launch."""
    gen = torch.Generator().manual_seed(29)
    n_r, L = 11, 64
    calls = [(70, 0, 20), (45, 20, 44)]  # (K, l_base, L_b)
    inputs = [_b1_inputs(gen, K, lb, n_r, dr_s, cuda, dtype, n, dl) for K, _, lb in calls]
    batch, slots, cstarts = _tiles_as_batch(inputs, calls, L, n_r, cuda)
    repeats = int((slots.slots < 0).sum())
    assert repeats >= 70 * 20 + 45 * 44 - 11 * 64 - 64  # nearly every slot past a landmark's 11th
    n_rows, nab = int(cstarts[-1]), dr_s * (dr_s + 3) // 2

    def assemble(kernel, dt):
        bufs = fused_obs.zero_buffers(L, n_r, dr_s, dl, n_rows, dt, cuda)
        x = [t.to(dt) if t.is_floating_point() else t for t in batch]
        kernel(*x, slots, *bufs, n_r, dr_s, dl, e_start)
        return list(bufs[:3]) + [segment_sum.segment_block_sum(bufs[3], cstarts)]

    before = fused_obs.INTO_LAUNCHES
    got = assemble(fused_obs.fused_obs_all_into, dtype)
    torch.cuda.synchronize()
    assert fused_obs.INTO_LAUNCHES == before + 1
    ref = assemble(fused_obs.fused_obs_all_into_reference, torch.float64)
    for name, a, b in zip(("h_ll", "g_l", "w", "ab"), got, ref):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    again = assemble(fused_obs.fused_obs_all_into, dtype)
    assert fused_obs.INTO_LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_any_shape_plan_matches_the_source(cuda):
    """The host's mirror of the any-shape instance's shared memory
    (``fused_obs.any_shape_plan``) gives the source's bytes and warps a
    block at every shape within the old caps and over a sweep past them
    (NRSfM's, and shapes whose one warp no longer fits), in both float
    types; ``kernel_takes`` holds exactly where the source launches."""
    lib = _build.library()
    shapes = [(n, dr_s, dl) for n in range(1, 5) for dr_s in range(1, 17) for dl in range(1, 7)]
    shapes += [(n, dr_s, dl) for n in (5, 8, 21) for dr_s in (6, 17, 40)
               for dl in (7, 9, 18, 33, 100, 300)]
    for n, dr_s, dl in shapes:
        for dtype in (torch.float32, torch.float64):
            plan = fused_obs.any_shape_plan(n, dr_s, dl, dtype)
            f64 = int(dtype == torch.float64)
            got = (lib.fused_obs_any_bytes(n, dr_s, dl, f64),
                   lib.fused_obs_any_warps(n, dr_s, dl, f64))
            assert got == (plan.block_bytes, plan.warps), (n, dr_s, dl, dtype)
            assert fused_obs.kernel_takes(n, dr_s, dl, dtype) == (plan.warps >= 1)


def _row_w(gen, L, dl, n_blocks, width):
    """An obs-major-like W ``[L, dl, n_blocks·width]``: landmark l holds a
    random subset of the camera blocks (every 9th none: its costs would
    see fixed cameras only), zero elsewhere, and its host
    :class:`schur_reduce.RowTables`."""
    held = torch.rand(L, n_blocks, generator=gen) < min(1.0, 12.0 / n_blocks)
    held[::9] = False
    lmk, blk = held.nonzero(as_tuple=True)
    w = torch.zeros(L, dl, n_blocks, width, dtype=torch.float64)
    w[lmk, :, blk] = torch.randn(len(lmk), dl, width, generator=gen, dtype=torch.float64)
    return (w.reshape(L, dl, n_blocks * width),
            schur_reduce.row_tables(lmk.numpy(), blk.numpy(), L,
                                    *schur_reduce.uniform_blocks(n_blocks, width)))


@pytest.mark.cuda
# B3 is float32 only (a float64 solve takes damped_inverse, then B4).
# The main paths' structures: the pinhole bench (128 cameras of 6), the
# Snavely BAL widths (128 and 49 cameras of 9); blocks of 8 and 4 through
# the kernel's any-width instance; dl = 2 (the planar path's) and 1.
@pytest.mark.parametrize("wc,width,lam,dl", [
    (128, 8, 0.0, 3), (768, 6, 1e-2, 3), (1152, 9, 0.0, 3), (100, 4, 0.5, 3), (441, 9, 1e-2, 3),
    (768, 6, 1e-2, 2), (128, 8, 0.0, 2), (441, 9, 1e-2, 1), (100, 4, 0.5, 1),
])
def test_reduce_s_damped_kernel_matches_plain(cuda, wc, width, lam, dl):
    gen = torch.Generator().manual_seed(5)
    L, tol = 777, 1e-5
    w, tables = _row_w(gen, L, dl, wc // width, width)
    a = torch.randn(dl, dl, L, generator=gen, dtype=torch.float64)
    h_ll = torch.einsum("del,fel->dfl", a, a) + 2.0 * torch.eye(dl, dtype=torch.float64)[:, :, None]
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    rows = schur_reduce.upload_tables(tables, cuda)
    args = [t.to(device=cuda, dtype=torch.float32) for t in (w, h_ll, g_l)]
    before, before_b4 = schur_reduce.LAUNCHES, schur_reduce.LM_LAUNCHES
    out = schur_reduce.reduce_s_damped(*args, lam, rows)
    torch.cuda.synchronize()
    assert schur_reduce.LAUNCHES == before + 1 and schur_reduce.LM_LAUNCHES == before_b4
    ref = schur_reduce.reduce_s_damped_reference(*(t.to(cuda) for t in (w, h_ll, g_l)), lam)
    for name, x, y in zip(("s_sum", "rhs_sum", "h_inv"), out, ref):
        assert x.shape == y.shape, name
        assert _rel_err(x, y) <= tol, (name, _rel_err(x, y))
    assert torch.equal(out[0], out[0].T)  # one writer per entry and its mirror
    again = schur_reduce.reduce_s_damped(*args, lam, rows)
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    with pytest.raises(ValueError):  # B3 needs W's row tables
        schur_reduce.reduce_s_damped(*args, lam)
    with pytest.raises(TypeError):  # and float32
        schur_reduce.reduce_s_damped(*(t.double() for t in args), lam, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dl", [1, 2])
@pytest.mark.parametrize("width", [6, 9])
@pytest.mark.parametrize("shift", [0, 1])
def test_links_instances_at_dl_1_2(cuda, dl, width, shift):
    """B3 (float32) and B4 (float32, float64) at dl 1 and 2 over camera
    blocks of 6 and 9: from column 0, the uniform W of an obs-major batch
    (the two-link instances that skip the block tables), or one column on
    (``shift``: the same widths read from the tables), against the plain
    versions (1e-5, float64 1e-12 of the largest entry); s_sum exactly
    symmetric, the same bits on a second launch, the launch counters
    moved."""
    gen = torch.Generator().manual_seed(31 + 10 * dl + width + shift)
    L, n_blocks = 777, 1152 // 9 if width == 9 else 768 // 6
    w, tables = _row_w(gen, L, dl, n_blocks, width)
    if shift:
        w = torch.cat([torch.zeros(L, dl, shift, dtype=torch.float64), w], dim=2)
        tables = tables._replace(bcol=tables.bcol + shift, n_cols=tables.n_cols + shift)
    rows = schur_reduce.upload_tables(tables, cuda)
    a = torch.randn(dl, dl, L, generator=gen, dtype=torch.float64)
    h_ll = torch.einsum("del,fel->dfl", a, a) + 2.0 * torch.eye(dl, dtype=torch.float64)[:, :, None]
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    h_inv = _spd_inverses(gen, dl, L)
    args = [t.to(device=cuda, dtype=torch.float32) for t in (w, h_ll, g_l)]
    before = schur_reduce.LAUNCHES
    out = schur_reduce.reduce_s_damped(*args, 1e-2, rows)
    again = schur_reduce.reduce_s_damped(*args, 1e-2, rows)
    torch.cuda.synchronize()
    assert schur_reduce.LAUNCHES == before + 2
    ref = schur_reduce.reduce_s_damped_reference(*(t.to(cuda) for t in (w, h_ll, g_l)), 1e-2)
    for name, x, y in zip(("s_sum", "rhs_sum", "h_inv"), out, ref):
        assert _rel_err(x, y) <= 1e-5, (name, _rel_err(x, y))
    assert torch.equal(out[0], out[0].T)
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    ref = schur_reduce.reduce_s_reference(*(t.to(cuda) for t in (w, h_inv, g_l)))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = [t.to(device=cuda, dtype=dtype) for t in (w, h_inv, g_l)]
        before = schur_reduce.LM_LAUNCHES
        out = schur_reduce.reduce_s_lm(*args, rows)
        again = schur_reduce.reduce_s_lm(*args, rows)
        torch.cuda.synchronize()
        assert schur_reduce.LM_LAUNCHES == before + 2
        for name, x, y in zip(("s_sum", "rhs_sum"), out, ref):
            assert _rel_err(x, y) <= tol, (dtype, name, _rel_err(x, y))
        assert torch.equal(out[0], out[0].T)
        assert all(torch.equal(x, y) for x, y in zip(out, again))


@pytest.mark.cuda
def test_reduce_s_damped_over_fixed_cameras(cuda):
    """B3 on a real float32 system whose cameras 1 and 2 are fixed: the
    compiled row tables give the landmarks seen by fixed cameras only one
    incidence without a block, and B3 still writes their inverses (all
    h_inv against the plain version, 1e-5); through ``SchurOps.solve`` the
    step matches the plain kernels' to 5e-4 of its largest entry (on the
    CPU two float32 summation orders of this system give steps 3.5e-5
    apart, the float64 step 3.8e-5 from the plain one; a wrong block moves
    it by order one)."""
    from nllstpu_torch.core.manifolds import Euclidean
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    problem, cams, lmks = make_pinhole_ba(8, 64, 0.3, noise=1e-3, dtype=torch.float32,
                                          batched="cm", device=cuda)
    perturb_ba(problem, lmks, 0.03, seed=2)
    comp = compile_problem(problem, cams[:1] + cams[3:] + lmks, solver="schur",
                           schur_family=Euclidean(3))
    rows = comp.schur_info.w_rows
    assert int((rows.blk < 0).sum()) > 0
    _, sys_ = comp.assemble(problem.stacked_variables())
    _, _, h_ll, g_l, w = sys_
    lam = 1e-3 * float(torch.diagonal(h_ll).abs().max())
    before = schur_reduce.LAUNCHES
    out = schur_reduce.reduce_s_damped(w, h_ll, g_l, lam, rows)
    torch.cuda.synchronize()
    assert schur_reduce.LAUNCHES == before + 1
    ref = schur_reduce.reduce_s_damped_reference(w.double(), h_ll.double(), g_l.double(), lam)
    for name, x, y in zip(("s_sum", "rhs_sum", "h_inv"), out, ref):
        assert _rel_err(x, y) <= 1e-5, (name, _rel_err(x, y))
    assert torch.isfinite(out[2]).all() and torch.equal(out[0], out[0].T)
    plain = compile_problem(problem, cams[:1] + cams[3:] + lmks, solver="schur",
                            schur_family=Euclidean(3), plain=True)
    x = comp.ctx().linops.solve(sys_, lam)
    x_plain = plain.ctx().linops.solve(sys_, lam)
    assert _rel_err(x, x_plain) <= 5e-4


def _spd_inverses(gen, dl, L):
    a = torch.randn(L, dl, dl, generator=gen, dtype=torch.float64)
    h = a @ a.transpose(1, 2) + 2.0 * torch.eye(dl, dtype=torch.float64)
    return torch.linalg.inv(h).permute(1, 2, 0).contiguous()  # [dl, dl, L]


def _structured_w(gen, L, dl, widths, spare, kernel=False):
    """A W zero outside a random block structure: blocks of ``widths``
    with ``spare`` columns between some of them, landmark l holding a
    random subset (every 9th none, every 13th only the last block; with
    ``kernel``, every landmark that holds a block also holds the last, as
    an adaptive kernel's), and its :class:`schur_reduce.RowTables`."""
    widths = torch.as_tensor(widths)
    gaps = torch.randint(0, spare + 1, (len(widths),), generator=gen)
    bcol = (torch.cumsum(widths + gaps, 0) - widths).tolist()
    wc = int(bcol[-1] + widths[-1] + spare)
    held = torch.rand(L, len(widths), generator=gen) < 0.4
    held[::9] = False
    held[::13] = False
    held[::13, -1] = True
    if kernel:
        held[:, -1] |= held.any(1)
    lmk, blk = held.nonzero(as_tuple=True)
    w = torch.zeros(L, dl, wc, dtype=torch.float64)
    for l, b in zip(lmk.tolist(), blk.tolist()):
        w[l, :, bcol[b] : bcol[b] + int(widths[b])] = torch.randn(dl, int(widths[b]), generator=gen)
    return w, schur_reduce.row_tables(lmk.numpy(), blk.numpy(), L, bcol, widths.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
# dl = 3 at the adaptive BAL structure (128 cameras of 9 columns and a
# 3-column kernel block held by every landmark); dl up to 6 over blocks
# of mixed widths up to the kernel's 16, spare columns between them; dl
# 7 and 16 through the tiled instance.
@pytest.mark.parametrize("dl,widths,spare", [
    (3, [9] * 128 + [3], 0), (5, [4, 16, 1, 9, 9, 7, 2], 3), (1, [1, 2, 3, 5, 8], 2),
    (6, [9] * 40 + [16], 1), (2, [6] * 30, 0), (4, [3] * 60, 5),
    (7, [4, 16, 1, 9, 9, 7, 2], 3), (16, [9] * 40 + [16], 1),
])
def test_reduce_s_kernel_matches_plain(cuda, dtype, tol, dl, widths, spare):
    gen = torch.Generator().manual_seed(dl)
    L = 777
    w, tables = _structured_w(gen, L, dl, widths, spare, kernel=len(widths) == 129)
    h_inv = _spd_inverses(gen, dl, L)
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    pairs = schur_reduce.upload_tables(tables, cuda)
    args = [t.to(device=cuda, dtype=dtype) for t in (w, h_inv, g_l)]
    before, before_b3 = schur_reduce.EXTERNAL_LAUNCHES, schur_reduce.LAUNCHES
    before_b4 = schur_reduce.LM_LAUNCHES
    out = schur_reduce.reduce_s(*args, pairs=pairs)
    torch.cuda.synchronize()
    assert schur_reduce.EXTERNAL_LAUNCHES == before + 1 and schur_reduce.LAUNCHES == before_b3
    assert schur_reduce.LM_LAUNCHES == before_b4
    ref = schur_reduce.reduce_s_reference(*(t.to(cuda) for t in (w, h_inv, g_l)))
    for name, x, y in zip(("s_sum", "rhs_sum"), out, ref):
        assert x.shape == y.shape, name
        assert _rel_err(x, y) <= tol, (name, _rel_err(x, y))
    assert torch.equal(out[0], out[0].T)  # one writer per entry and its mirror
    again = schur_reduce.reduce_s(*args, pairs=pairs)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    with pytest.raises(ValueError):  # B5 needs W's structure
        schur_reduce.reduce_s(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
# The gauge-fixed pinhole width (126 cameras of 6) and the pinhole bench's;
# wc = 1155 as the adaptive BAL width; every dl from 1 to 6, past B3's
# closed form, over blocks of 4 to 16 columns (the any-width instance);
# dl 7 and 16 through the tiled instance.
@pytest.mark.parametrize("dl,wc,width", [
    (3, 756, 6), (3, 768, 6), (3, 1155, 11), (5, 100, 5), (1, 64, 16), (6, 441, 9), (2, 130, 10),
    (4, 200, 8), (7, 441, 9), (16, 768, 6), (16, 320, 16),
])
def test_reduce_s_lm_kernel_matches_plain(cuda, dtype, tol, dl, wc, width):
    gen = torch.Generator().manual_seed(wc)
    L = 777
    w, tables = _row_w(gen, L, dl, wc // width, width)
    h_inv = _spd_inverses(gen, dl, L)
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    rows = schur_reduce.upload_tables(tables, cuda)
    args = [t.to(device=cuda, dtype=dtype) for t in (w, h_inv, g_l)]
    before, before_b5 = schur_reduce.LM_LAUNCHES, schur_reduce.EXTERNAL_LAUNCHES
    out = schur_reduce.reduce_s_lm(*args, rows)
    torch.cuda.synchronize()
    assert schur_reduce.LM_LAUNCHES == before + 1
    assert schur_reduce.EXTERNAL_LAUNCHES == before_b5
    ref = schur_reduce.reduce_s_reference(*(t.to(cuda) for t in (w, h_inv, g_l)))
    for name, x, y in zip(("s_sum", "rhs_sum"), out, ref):
        assert x.shape == y.shape, name
        assert _rel_err(x, y) <= tol, (name, _rel_err(x, y))
    assert torch.equal(out[0], out[0].T)
    again = schur_reduce.reduce_s_lm(*args, rows)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    with pytest.raises(ValueError):  # B4 needs W's row tables
        schur_reduce.reduce_s_lm(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("dl", [7, 16, 17, 33])
@pytest.mark.parametrize("name", ["reduce_s", "reduce_s_lm"])
def test_tiled_instance_matches_plain(cuda, dtype, tol, dl, name):
    """B4 and B5 past the unrolled dl ≤ 6 (the tiled instance: whole links
    a stage, and at dl 33 in float64 a link's rows in chunks) over blocks
    of every width from 1 to 16, spare columns between some, against the
    dense plain version; s_sum exactly symmetric, two launches the same
    bits, and only the wrapper's own counter moved."""
    gen = torch.Generator().manual_seed(100 + dl)
    L = 333
    w, tables = _structured_w(gen, L, dl, list(range(16, 0, -1)), 2)
    h_inv = _spd_inverses(gen, dl, L)
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    rows = schur_reduce.upload_tables(tables, cuda)
    args = [t.to(device=cuda, dtype=dtype) for t in (w, h_inv, g_l)]
    counters = ("LAUNCHES", "LM_LAUNCHES", "EXTERNAL_LAUNCHES")
    before = {c: getattr(schur_reduce, c) for c in counters}
    out = getattr(schur_reduce, name)(*args, rows)
    torch.cuda.synchronize()
    own = "EXTERNAL_LAUNCHES" if name == "reduce_s" else "LM_LAUNCHES"
    assert {c: getattr(schur_reduce, c) - before[c] for c in counters} == {
        c: int(c == own) for c in counters}
    ref = schur_reduce.reduce_s_reference(*(t.to(cuda) for t in (w, h_inv, g_l)))
    for label, x, y in zip(("s_sum", "rhs_sum"), out, ref):
        assert x.shape == y.shape, label
        assert _rel_err(x, y) <= tol, (label, _rel_err(x, y))
    assert torch.equal(out[0], out[0].T)
    again = getattr(schur_reduce, name)(*args, rows)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


def _b7_case(gen, L, dl, dr_s, n_r, extra):
    """Runs of 0-39 costs (empty ones included) with repeated cameras,
    dropped costs (a negative column, one past W's columns) and ``extra``
    columns no cost reaches."""
    lengths = torch.randint(0, 40, (L,), generator=gen)
    lengths[::7] = 0
    lstarts = torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)]).int()
    n = int(lstarts[-1])
    wc = n_r * dr_s + extra
    colbase = (torch.randint(0, n_r, (n,), generator=gen) * dr_s).int()
    colbase[::11] = -1
    colbase[5::13] = wc - dr_s + 1
    return torch.randn(n, dl, dr_s, generator=gen, dtype=torch.float64), lstarts, colbase, wc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
# Snavely cameras with a 3-dof kernel; a float64 row of 3·3000·8 = 72 KB
# takes the dynamic shared memory past 48 KB; a float64 row of 18·1620·8 =
# 233,280 bytes is past the 232,448 a block holds, so it is built in
# column spans (its float32 row, half that, whole).
@pytest.mark.parametrize("dl,dr_s,n_r,extra", [(3, 9, 37, 3), (3, 9, 333, 3), (2, 6, 5, 0),
                                               (18, 9, 180, 0)])
def test_place_w_kernel_matches_plain(cuda, dtype, tol, dl, dr_s, n_r, extra):
    gen = torch.Generator().manual_seed(n_r)
    we, lstarts, colbase, wc = _b7_case(gen, 300 if dl < 18 else 60, dl, dr_s, n_r, extra)
    before = w_place.LAUNCHES
    args = (lstarts.to(cuda), colbase.to(cuda), wc)
    out = w_place.place_w(we.to(cuda, dtype), *args)
    torch.cuda.synchronize()
    assert w_place.LAUNCHES == before + 1
    ref = w_place.place_w_reference(we, lstarts, colbase, wc)
    assert out.shape == ref.shape and out.dtype == dtype
    assert _rel_err(out.cpu(), ref) <= tol
    assert not out[:, :, n_r * dr_s :].any()
    empty = (lstarts[1:] == lstarts[:-1]).nonzero()[:, 0]
    assert len(empty) and not out[empty.to(cuda)].any()
    assert torch.equal(out, w_place.place_w(we.to(cuda, dtype), *args))


def _b6_case(gen, n_runs, d, long_run):
    """Skewed runs: empty ones, one of ``long_run`` rows, and rows before
    the first and after the last run that must be ignored."""
    lengths = torch.randint(0, 40, (n_runs,), generator=gen)
    lengths[::7] = 0
    lengths[n_runs // 2] = long_run
    starts = 5 + torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)])
    data = torch.randn(int(starts[-1]) + 9, d, generator=gen, dtype=torch.float64)
    return data, starts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
# D of the implicit path: Wᵀv, W u, h_ll + g_l, a_rr + b_r (and B2's camera
# side), the preconditioner's correction; B1's camera side (27); one run
# of 100,000 rows.
@pytest.mark.parametrize("d", [3, 9, 12, 27, 54, 81])
def test_segment_block_sum_kernel_matches_plain(cuda, dtype, tol, index, d):
    gen = torch.Generator().manual_seed(d)
    data, starts = _b6_case(gen, 300, d, 100_000)
    before = segment_sum.LAUNCHES
    out = segment_sum.segment_block_sum(data.to(cuda, dtype), starts.to(cuda, index))
    torch.cuda.synchronize()
    assert segment_sum.LAUNCHES == before + 1
    ref = segment_sum.segment_block_sum_reference(data, starts)
    assert out.shape == ref.shape and out.dtype == dtype
    assert _rel_err(out.cpu(), ref) <= tol
    empty = (starts[1:] == starts[:-1]).nonzero()[:, 0]
    assert len(empty) and not out[empty.to(cuda)].any()
    # Deterministic: the same bits on a second launch.
    again = segment_sum.segment_block_sum(data.to(cuda, dtype), starts.to(cuda, index))
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 27, 81])
def test_segment_block_sum_long_run_beside_one_row_runs(cuda, d):
    """One run of 100,000 rows next to 10,000 one-row runs, empty runs
    between them and ignored rows around them: float64 against the plain
    version (1e-12) and, bit for bit, against the plain mirror of the
    kernel's chunk order; the same bits on a second launch."""
    gen = torch.Generator().manual_seed(100 + d)
    lengths = torch.ones(10_001, dtype=torch.long)
    lengths[::97] = 0
    lengths[5000] = 100_000
    starts = 3 + torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)])
    data = torch.randn(int(starts[-1]) + 4, d, generator=gen, dtype=torch.float64)
    out = segment_sum.segment_block_sum(data.to(cuda), starts.to(cuda))
    again = segment_sum.segment_block_sum(data.to(cuda), starts.to(cuda))
    torch.cuda.synchronize()
    assert _rel_err(out.cpu(), segment_sum.segment_block_sum_reference(data, starts)) <= 1e-12
    assert torch.equal(out.cpu(), segment_sum.segment_block_sum_chunked(data, starts))
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_compile_problem_builds_the_library(cuda):
    """compile_problem on the card loads the kernel library before the
    optimization's clock starts; the plain baseline does not need it."""
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.core.manifolds import Euclidean
    from nllstpu_torch.models.ba import make_pinhole_ba

    problem, _, _ = make_pinhole_ba(4, 32, 0.8, noise=1e-3, dtype=torch.float32, batched="cm",
                                    device=cuda)
    compile_problem(problem, solver="schur", schur_family=Euclidean(3))
    assert _build._lib is not None


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda):
    w = torch.zeros(4, 5, 6, device=cuda)
    with pytest.raises(ValueError):
        schur_reduce.reduce_s_damped(w, torch.zeros(3, 3, 4, device=cuda), torch.zeros(3, 4, device=cuda), 0.0)
    # Eight residual rows of 206 columns: a warp's 32 staged slots past the
    # shared memory a block holds.
    jac = torch.zeros(8, 206, 2, 4, device=cuda)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_obs.fused_obs_all(
            jac, torch.zeros(206, 2, 4, device=cuda), torch.zeros(2, 4, device=cuda),
            torch.zeros(2, 4, device=cuda), idx, idx,
            torch.zeros(6, dtype=torch.int32, device=cuda), 5, 6, 200, 6,
        )
    with pytest.raises(ValueError):
        segment_sum.segment_block_sum(w, torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        segment_sum.segment_block_sum(w[0], torch.zeros(3, device=cuda))
    for reduce in (schur_reduce.reduce_s, schur_reduce.reduce_s_lm):
        with pytest.raises(ValueError, match="dl must be"):  # dl = 0
            reduce(
                torch.zeros(4, 0, 6, device=cuda), torch.zeros(0, 0, 4, device=cuda),
                torch.zeros(0, 4, device=cuda),
            )
    with pytest.raises(ValueError, match="block widths"):  # a block 17 wide
        schur_reduce.row_tables([0, 1], [0, 0], 2, [0], [17])
    starts = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # int64 columns
        w_place.place_w(w, starts, torch.zeros(4, dtype=torch.long, device=cuda), 12)
    with pytest.raises(ValueError):  # a camera wider than W
        w_place.place_w(w, starts, torch.zeros(4, dtype=torch.int32, device=cuda), 5)


def test_plain_versions_run_on_cpu():
    """The CPU half of this file: both plain versions produce the shapes
    the kernels promise."""
    gen = torch.Generator().manual_seed(2)
    inputs = _b1_inputs(gen, 3, 10, 4, 6, "cpu", torch.float64)
    tables = fused_obs.camera_tables(inputs[4], 4)
    h, g, w, ab = fused_obs.fused_obs_all(*inputs, *tables, 4, 6, 3, 6)
    assert (h.shape, g.shape, w.shape, ab.shape) == (
        (3, 3, 10), (3, 10), (10, 3, 24), (4, 27)
    )
    assert torch.allclose(h, h.transpose(0, 1), rtol=1e-14, atol=0)
    s, r, hi = schur_reduce.reduce_s_damped(w, h + 5 * torch.eye(3, dtype=h.dtype)[:, :, None], g, 0.1)
    assert (s.shape, r.shape, hi.shape) == ((24, 24), (24,), (3, 3, 10))
    assert np.isfinite(s.numpy()).all()
    data, starts = _b6_case(gen, 12, 5, 70)
    out = segment_sum.segment_block_sum(data, starts)
    assert out.shape == (12, 5)
    for i in range(12):
        assert torch.allclose(out[i], data[starts[i]:starts[i + 1]].sum(0), rtol=1e-14, atol=1e-14)
    s5, r5 = schur_reduce.reduce_s(w, hi, g)
    assert torch.allclose(s5, s, rtol=1e-12, atol=1e-12 * s.abs().max().item())
    assert torch.allclose(r5, r, rtol=1e-12, atol=1e-12 * r.abs().max().item())
    s4, r4 = schur_reduce.reduce_s_lm(w, hi, g)
    assert torch.equal(s4, s5) and torch.equal(r4, r5)
    h8, g8, w8 = fused_obs.fused_obs_leg(*inputs, 4, 6, 3, 6)
    assert torch.equal(h8, h) and torch.equal(g8, g) and torch.equal(w8, w)
    we, lstarts, colbase, wc = _b7_case(gen, 20, 3, 6, 4, 3)
    placed = w_place.place_w(we, lstarts, colbase, wc)
    assert placed.shape == (20, 3, wc)
    for i in range(20):
        expect = torch.zeros(3, wc, dtype=we.dtype)
        for b in range(int(lstarts[i]), int(lstarts[i + 1])):
            if 0 <= colbase[b] <= wc - 6:
                expect[:, colbase[b] : colbase[b] + 6] += we[b]
        assert torch.allclose(placed[i], expect, rtol=1e-14, atol=1e-14)


@pytest.mark.cuda
def test_reduce_s_damped_reads_lambda_from_device(cuda):
    """B3 with λ a 0-d float64 tensor on the card: its plain version's
    result (1e-5 of the largest entry) and the float λ's bits; captured in
    a CUDA graph, each replay takes the λ written before it."""
    gen = torch.Generator().manual_seed(8)
    L, dl = 777, 3
    w, tables = _row_w(gen, L, dl, 128, 6)
    a = torch.randn(dl, dl, L, generator=gen, dtype=torch.float64)
    h_ll = torch.einsum("del,fel->dfl", a, a) + 2.0 * torch.eye(dl, dtype=torch.float64)[:, :, None]
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    rows = schur_reduce.upload_tables(tables, cuda)
    args = [t.to(device=cuda, dtype=torch.float32) for t in (w, h_ll, g_l)]
    for lam in (0.0, 1e-2):
        lam_t = torch.tensor(lam, dtype=torch.float64, device=cuda)
        out = schur_reduce.reduce_s_damped(*args, lam_t, rows)
        ref = schur_reduce.reduce_s_damped_reference(*(t.to(cuda) for t in (w, h_ll, g_l)), lam)
        for name, x, y in zip(("s_sum", "rhs_sum", "h_inv"), out, ref):
            assert _rel_err(x, y) <= 1e-5, (name, _rel_err(x, y))
        again = schur_reduce.reduce_s_damped(*args, float(lam), rows)
        assert all(torch.equal(x, y) for x, y in zip(out, again))
    lam_t = torch.zeros((), dtype=torch.float64, device=cuda)
    schur_reduce.reduce_s_damped(*args, lam_t, rows)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = schur_reduce.LAUNCHES
    with torch.cuda.graph(graph):
        captured = schur_reduce.reduce_s_damped(*args, lam_t, rows)
    assert schur_reduce.LAUNCHES == before + 1  # the wrapper counts at capture
    for lam in (1e-2, 0.5):
        lam_t.fill_(lam)
        graph.replay()
        expect = schur_reduce.reduce_s_damped(*args, lam, rows)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(captured, expect)), lam


def _driver_case(cuda):
    """A float32 pinhole problem (16 cameras, 256 landmarks): B1, B6 and
    B3 on the direct path."""
    from nllstpu_torch.core.manifolds import Euclidean
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.core.structs import Options
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    problem, _, lmks = make_pinhole_ba(16, 256, 0.3, noise=1e-3, dtype=torch.float32,
                                       batched="cm", device=cuda)
    perturb_ba(problem, lmks, 0.05, seed=5)
    opts = Options(solver="schur", schur_family=Euclidean(3), max_iters=8)
    return problem, opts, compile_problem(problem, solver="schur", schur_family=opts.schur_family)


@pytest.mark.cuda
def test_captured_trial_replays_the_eager_trial(cuda):
    """The graph driver's captured assembly and damped trials (through the
    reduced system's Cholesky and through LU), replayed at two λ, give the
    eager pieces' bits; the launch counters count the warm-up's launches,
    none at capture, none at a replay, and when the run returns what each
    capture counted once per replay of the run."""
    from nllstpu_torch.core import optimize

    problem, opts, comp = _driver_case(cuda)
    vars0 = problem.stacked_variables()
    counts = (fused_obs.LAUNCHES, segment_sum.LAUNCHES, schur_reduce.LAUNCHES)
    runner = optimize._GraphRunner(comp, opts, vars0)
    assert set(runner.graphs) == {"assemble", "trial", "trial_lu"}
    warm = (fused_obs.LAUNCHES, segment_sum.LAUNCHES, schur_reduce.LAUNCHES)
    # One warm-up run and one first replay of each piece.
    assert [b - a for a, b in zip(counts, warm)] == [2, 2, 4]
    ctx = comp.ctx(opts)
    _, sys_e = comp.assemble(vars0)
    g_e = ctx.grad(sys_e)
    runner.assemble(runner.vars)
    for e, r in zip(sys_e, runner.sys):
        assert torch.equal(e, r)
    lam_max = float(ctx.linops.diag_max(sys_e))
    for lam in (np.float32(1e-2 * lam_max), np.float32(1e-4 * lam_max)):
        nv_e, x_e, read_e = ctx.trial(sys_e, g_e, vars0, lam)
        nv_g, x_g, read_g = runner.trial(None, None, None, lam)
        assert read_g[4] == 1.0 and read_g[:4] == read_e[:4]
        assert torch.equal(x_g, x_e)
        assert all(torch.equal(nv_g[k], nv_e[k]) for k in nv_e)
        x_lu, _ = ctx.linops.solve_ex(sys_e, torch.tensor(float(lam), dtype=torch.float64,
                                                            device=cuda), lu=True)
        _, x_glu, _ = runner.trial(None, None, None, lam, lu=True)
        assert torch.equal(x_glu, -x_lu)
    torch.cuda.synchronize()
    after = (fused_obs.LAUNCHES, segment_sum.LAUNCHES, schur_reduce.LAUNCHES)
    # The eager calls' own launches (one assembly: B1 and its B6; two trials
    # and two LU solves: B3 each); the replays are not counted yet.
    assert [b - a for a, b in zip(warm, after)] == [1, 1, 4]
    assert runner.replays == 5
    assert dict(runner.piece_replays) == {"assemble": 1, "trial": 2, "trial_lu": 2}
    # The run goes on from these replays; when it returns, every replay of
    # it is counted: an assembly B1 and its B6, a trial B3.
    final = runner.run()
    done = (fused_obs.LAUNCHES, segment_sum.LAUNCHES, schur_reduce.LAUNCHES)
    r = final["replays"]
    assert r == dict(runner.piece_replays) and r["assemble"] > 1
    assert [b - a for a, b in zip(after, done)] == [
        r["assemble"], r["assemble"], r["trial"] + r.get("trial_lu", 0)]


@pytest.mark.cuda
def test_graph_driver_matches_the_stepped_driver(cuda):
    """The graph driver through ``optimize`` against the stepped one
    (``callback=null_callback``) on the card: the same iterations, damped
    solves and cost trace bit for bit; a plain compile is refused."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem, run_graphs

    problem, opts, _ = _driver_case(cuda)
    r_g = nt.optimize(problem, opts)
    problem, opts, _ = _driver_case(cuda)
    r_s = nt.optimize(problem, opts, callback=nt.null_callback)
    assert r_g.num_iterations == r_s.num_iterations and r_g.linear_solves == r_s.linear_solves
    assert r_g.costs == r_s.costs
    plain = compile_problem(problem, solver="schur", schur_family=opts.schur_family, plain=True)
    with pytest.raises(ValueError, match="plain"):
        run_graphs(plain, opts, problem.stacked_variables())


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A piece that reads the host cannot be captured: the graph driver
    raises and names it (no eager loop in its place)."""
    from nllstpu_torch.core.optimize import run_graphs

    problem, opts, comp = _driver_case(cuda)
    cost = comp.cost
    comp.cost = lambda v: cost(v) * float(cost(v))  # a host read
    with pytest.raises(RuntimeError, match="capture of 'trial' failed"):
        run_graphs(comp, opts, problem.stacked_variables())


@pytest.mark.cuda
def test_dense_assembly_is_deterministic_on_the_card(cuda):
    """The dense backend's assembly of a pose graph (float64, per-cost
    autodiff Jacobians): its sums through B6 give the same bits in cost, H
    and g twice, two B6 launches per assembly (H's and g's), and the CPU
    assembly's values within 1e-12 of the largest entry."""
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.posegraph import make_pose_graph

    out = {}
    for dev in (cuda, torch.device("cpu")):
        problem, poses, _ = make_pose_graph(200, 400, noise=0.01, device=dev)
        comp = compile_problem(problem, poses[1:], solver="dense")
        variables = problem.stacked_variables()
        before = segment_sum.LAUNCHES
        out[dev.type] = [comp.assemble(variables) for _ in range(2)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert segment_sum.LAUNCHES - before == 4
    (c1, (h1, g1)), (c2, (h2, g2)) = out["cuda"]
    assert torch.equal(c1, c2) and torch.equal(h1, h2) and torch.equal(g1, g2)
    c0, (h0, g0) = out["cpu"][0]
    for a, b in ((c1, c0), (h1, h0), (g1, g0)):
        assert _rel_err(a.cpu(), b) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("iterator", ["newton", "dogleg", "gradient_descent"])
def test_new_iterators_graph_driver_matches_stepped(cuda, iterator):
    """Newton (on the dense pose graph: a well-posed λ = 0 solve), dogleg
    and gradient descent (on the float32 pinhole problem: B1, B6, B3 at
    λ = 0) through ``optimize``'s graph driver against the stepped one:
    the same iterations, solves, cost evaluations and cost trace bit for
    bit."""
    import dataclasses

    import nllstpu_torch as nt
    from nllstpu_torch.models.posegraph import make_pose_graph

    def case():
        if iterator == "newton":
            problem, poses, _ = make_pose_graph(50, 40, noise=0.01, device=cuda)
            return problem, nt.Options(iterator=iterator, solver="dense"), dict(
                unfixed=poses[1:])
        problem, opts, _ = _driver_case(cuda)
        return problem, dataclasses.replace(opts, iterator=iterator), {}

    problem, opts, route = case()
    r_g = nt.optimize(problem, opts, **route)
    problem, opts, route = case()
    r_s = nt.optimize(problem, opts, callback=nt.null_callback, **route)
    assert (r_g.num_iterations, r_g.linear_solves, r_g.cost_computations) == (
        r_s.num_iterations, r_s.linear_solves, r_s.cost_computations)
    assert r_g.num_iterations >= 2 and r_g.costs == r_s.costs


@pytest.mark.cuda
def test_capture_survives_collected_runners(cuda):
    """Runners left to the cyclic garbage collector (their CUDA graphs
    with them) while later runners capture, with the collector made to run
    at almost every allocation: no capture is invalidated by a graph
    destroyed mid-capture, and every run gives the first run's trace."""
    import dataclasses
    import gc

    from nllstpu_torch.core.optimize import run_graphs

    problem, opts, comp = _driver_case(cuda)
    opts = dataclasses.replace(opts, iterator="dogleg", max_iters=3)
    vars0 = problem.stacked_variables()
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        traces = [run_graphs(comp, opts, vars0)["trace"] for _ in range(4)]
    finally:
        gc.set_threshold(*old)
    assert all([c.tobytes() for c in t] == [c.tobytes() for c in traces[0]] for t in traces)


def _cg_case(cuda, iterator="levenberg_marquardt"):
    """A float64 pose graph (200 poses, 400 loop closures, pose 0 fixed)
    through the cg backend."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.posegraph import make_pose_graph

    problem, poses, _ = make_pose_graph(200, 400, noise=0.01, device=cuda)
    opts = nt.Options(iterator=iterator, solver="cg", max_iters=6, rel_dcost=1e-12)
    return problem, opts, poses[1:], compile_problem(problem, poses[1:], solver="cg")


@pytest.mark.cuda
def test_cg_matvec_through_b6_matches_plain(cuda):
    """The cg backend's assembly and matvec with their per-variable sums
    through B6 (one launch per sum) against the same through B6's plain
    version: float64 within 1e-12 of the largest entry, and two launches
    give the same bits."""
    import dataclasses

    from nllstpu_torch.ops import cg

    problem, _, _, comp = _cg_case(cuda)
    ops = comp.ctx().linops
    plain = dataclasses.replace(ops, segment_sum=segment_sum.segment_block_sum_reference)
    variables = problem.stacked_variables()
    before = segment_sum.LAUNCHES
    c, sys_ = cg.assemble_cg(comp.batches, variables, ops)
    x = torch.randn(ops.dim, dtype=torch.float64, device=cuda)
    lam = torch.tensor(1e-3, dtype=torch.float64, device=cuda)
    y, y2 = ops.matvec(sys_, lam, x), ops.matvec(sys_, lam, x)
    torch.cuda.synchronize()
    assert segment_sum.LAUNCHES - before == 3 + 2  # g, diagonal, blocks; two matvecs
    assert torch.equal(y, y2)
    c_p, sys_p = cg.assemble_cg(comp.batches, variables, plain)
    for a, b in ((c, c_p), (sys_[0], sys_p[0]), (sys_[3][0], sys_p[3][0]), (sys_[4], sys_p[4]),
                 (y, plain.matvec(sys_, lam, x))):
        assert _rel_err(a, b) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("iterator", ["levenberg_marquardt", "dogleg"])
def test_cg_pieces_capture_and_replay(cuda, iterator):
    """Every cg piece is captured in a CUDA graph (the assembly, the PCG's
    set-up, chunk and finish or leg, the combination trials) and its
    replays give the eager pieces' bits: one trial (or leg) at two λ; the
    graph driver through ``optimize`` gives the stepped driver's trace and
    PCG iterations."""
    import nllstpu_torch as nt
    from nllstpu_torch.core import optimize

    problem, opts, unfixed, comp = _cg_case(cuda, iterator)
    vars0 = problem.stacked_variables()
    runner = optimize._GraphRunner(comp, opts, vars0)
    expect = {"assemble", "pcg_setup", "pcg_chunk"} | (
        {"pcg_finish"} if iterator == "levenberg_marquardt"
        else {"pcg_leg", "trial_cauchy", "trial_newton", "trial_blend"})
    assert set(runner.graphs) == expect
    ctx = comp.ctx(opts)
    runner.assemble(runner.vars)
    with optimize._cusolver(cuda):  # the eager pieces factor as the captures do
        _, sys_e = comp.assemble(vars0)
        g_e = ctx.grad(sys_e)
        assert torch.equal(runner.g, g_e)
        if iterator == "levenberg_marquardt":
            for lam in (1e-2, 1e-5):
                _, x_e, read_e = ctx.trial(sys_e, g_e, vars0, np.float64(lam))
                _, x_g, read_g = runner.trial(None, None, None, np.float64(lam))
                assert read_g == read_e and torch.equal(x_g, x_e)
        else:
            legs_e, read_e = ctx.leg(sys_e, g_e)
            _, read_g = runner.leg(None, None)
            assert read_g == read_e and torch.equal(runner.xn, legs_e[0])
    assert runner.linops.cg_iters == ctx.linops.cg_iters[-len(runner.linops.cg_iters):]
    r_g = nt.optimize(problem, opts, unfixed=unfixed)
    problem, opts, unfixed, _ = _cg_case(cuda, iterator)
    r_s = nt.optimize(problem, opts, unfixed=unfixed, callback=nt.null_callback)
    assert r_g.num_iterations >= 2 and r_g.costs == r_s.costs


def _prior(measurement, x):
    return x - measurement


def _generic_case(cuda, dtype, solver="schur"):
    """A per-cost pinhole problem (autodiff Jacobians) with a prior batch on
    every seventh landmark, its first camera and two landmarks fixed: the
    generic Schur route, compiled with the kernels and with their plain
    versions."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    p, cams, lmks = make_pinhole_ba(6, 60, 0.6, noise=1e-3, dtype=dtype, device=cuda)
    perturb_ba(p, lmks, 0.03, seed=2)
    idx = np.arange(2, 60, 7)
    truth = p.stacked_variables()[nt.family_name(nt.Euclidean(3))][idx].cpu().numpy()
    p.add_cost_batch(_prior, slots=[(nt.Euclidean(3), idx)], params=truth + 0.01)
    unfixed = cams[1:] + lmks[2:]
    return p, [compile_problem(p, unfixed, solver=solver, schur_family=nt.Euclidean(3),
                               plain=plain) for plain in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_generic_direct_assembly_matches_plain(cuda, dtype, tol):
    """The generic direct assembly (keyed sums through B6, W placed by B7)
    and its damped solve (B5) against the plain versions, within ``tol``
    of the largest entry; two assemblies give the same bits; the path
    launches B5, B6 and B7 and none of B1–B4 or B8."""
    p, (comp, plain) = _generic_case(cuda, dtype)
    v = p.stacked_variables()
    before = (segment_sum.LAUNCHES, w_place.LAUNCHES, schur_reduce.EXTERNAL_LAUNCHES,
              fused_obs.LAUNCHES + fused_obs.INTO_LAUNCHES + fused_obs.LEG_LAUNCHES,
              schur_reduce.LAUNCHES + schur_reduce.LM_LAUNCHES)
    (c1, s1), (c2, s2) = comp.assemble(v), comp.assemble(v)
    x = comp.ctx().linops.solve(s1, 1e-2)
    torch.cuda.synchronize()
    after = (segment_sum.LAUNCHES, w_place.LAUNCHES, schur_reduce.EXTERNAL_LAUNCHES,
             fused_obs.LAUNCHES + fused_obs.INTO_LAUNCHES + fused_obs.LEG_LAUNCHES,
             schur_reduce.LAUNCHES + schur_reduce.LM_LAUNCHES)
    b6, b7, b5, obs_major, b34 = (a - b for a, b in zip(after, before))
    assert b6 == 2 * 3 and b7 == 2 and b5 == 1 and obs_major == 0 and b34 == 0
    assert torch.equal(c1, c2) and all(torch.equal(a, b) for a, b in zip(s1, s2))
    c_p, s_p = plain.assemble(v)
    for a, b in zip((c1, *s1), (c_p, *s_p)):
        assert _rel_err(a, b) <= tol
    x_p = plain.ctx().linops.solve(s_p, 1e-2)
    assert _rel_err(x, x_p) <= (1e-9 if dtype == torch.float64 else 1e-3)


@pytest.mark.cuda
def test_generic_implicit_matches_plain(cuda):
    """The implicit backend on the generic route: the assembly and one PCG
    solve through B6 against the plain versions (float64, 1e-12 and 1e-9),
    the same bits on a second assembly and solve."""
    p, (comp, plain) = _generic_case(cuda, torch.float64, solver="schur_cg")
    v = p.stacked_variables()
    (c1, s1), (c2, s2) = comp.assemble(v), comp.assemble(v)
    ops = comp.ctx().linops
    x1, x2 = ops.solve(s1, 1e-3), ops.solve(s2, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(x1, x2) and torch.equal(c1, c2)
    c_p, s_p = plain.assemble(v)
    for a, b in zip((c1, *s1[:4]), (c_p, *s_p[:4])):
        assert _rel_err(a, b) <= 1e-12
    assert _rel_err(x1, plain.ctx().linops.solve(s_p, 1e-3)) <= 1e-9


@pytest.mark.cuda
def test_percost_ladybug_graph_driver(cuda):
    """Three LM iterations of the Ladybug-49 per-cost problem (float64,
    34,619 observations, a prior batch on every 25th point) through the
    graph driver give the stepped driver's trace, launching B5, B6 and
    B7."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import PT, make_bal_problem, make_realistic_bal

    def problem():
        data = make_realistic_bal(ncameras=49, npoints=7776, seed=1, noise=1e-3, track_alpha=2.3)
        p, cams, pts = make_bal_problem(data, dtype=torch.float64, device=cuda, batched=False)
        idx = np.arange(3, len(pts), 25)
        p.add_cost_batch(_prior, slots=[(PT, idx)], params=data["points"][idx])
        perturb_ba(p, pts[3:], 0.05, seed=5)
        return p, cams[1:] + pts[3:]

    opts = nt.Options(solver="schur", schur_family=PT, max_iters=3, max_time=float("inf"))
    before = (segment_sum.LAUNCHES, w_place.LAUNCHES, schur_reduce.EXTERNAL_LAUNCHES)
    p, unfixed = problem()
    r_g = nt.optimize(p, opts, unfixed=unfixed)
    assert all(a > b for a, b in zip(
        (segment_sum.LAUNCHES, w_place.LAUNCHES, schur_reduce.EXTERNAL_LAUNCHES), before))
    p, unfixed = problem()
    r_s = nt.optimize(p, opts, unfixed=unfixed, callback=nt.null_callback)
    assert r_g.num_iterations == 3 and r_g.costs == r_s.costs
    assert r_g.costs[-1] < 0.01 * r_g.start_cost


def _view_case(cuda, dtype=torch.float32):
    """A small Snavely problem (12 cameras, 300 points) and its points."""
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import make_bal_problem, make_realistic_bal

    problem, _, points = make_bal_problem(
        make_realistic_bal(12, 300, seed=1, noise=1e-3, track_alpha=1.6), dtype=dtype,
        device=cuda)
    perturb_ba(problem, points, 0.01, seed=5)
    return problem, points


@pytest.mark.cuda
def test_subproblem_view_captures_once(cuda):
    """A view on the card swaps subsets through the graphs of its first
    capture (one capture across three swaps), each swap launching the
    obs-major assembly, B3 and B6, and gives a fresh subproblem's result
    in float64 (B4's route) within 1e-8."""
    import nllstpu_torch as nt
    from nllstpu_torch.core import optimize

    opts = nt.Options(max_iters=8, rel_dcost=1e-6, solver="schur",
                      schur_family=nt.Euclidean(3), max_time=float("inf"))
    problem, points = _view_case(cuda, torch.float64)
    view = nt.SubproblemView(problem, solver="schur", schur_family=nt.Euclidean(3))
    half = len(points) // 2
    for k, sel in enumerate((points[:half], points[half:], points[:half])):
        fresh, _ = _view_case(cuda, torch.float64)
        fresh.set_values(problem.stacked_variables())
        captures = optimize.CAPTURES
        r = view.select(sel).optimize(opts)
        assert view.capture_count == 1 and optimize.CAPTURES == captures + (k == 0)
        ref = nt.optimize(fresh.subproblem(sel), opts)
        gap = abs(r.best_cost - ref.best_cost) / abs(ref.best_cost)
        print(f"view swap {k + 1}: best {r.best_cost!r}, fresh {ref.best_cost!r}, "
              f"relative gap {gap:.3e}")
        # The view's camera runs hold the unselected costs' zero rows, which
        # regroup B6's chunks: the two sums part in the last bits (measured
        # on an H100: 6.7e-12, 1.6e-9 and 1.3e-10 for the three swaps).
        np.testing.assert_allclose(r.best_cost, ref.best_cost, rtol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("iterator", ["levenberg_marquardt", "newton", "dogleg",
                                      "gradient_descent"])
def test_singles_sums_through_b6(cuda, iterator):
    """``optimize_singles`` on the card sums every target's cost, gradient
    and Hessian through kernel B6, and in float64 is one more draw from
    the rounding that spreads its own CPU runs under a one-ulp change of
    the start (scaled by 1 and 1 ± 2⁻⁵²): the card's summed iterations lie
    in the CPU runs' range widened by its width, and its values are no
    farther from the unscaled CPU run (largest elementwise relative gap)
    than twice the farthest scaled CPU run.  At ``rel_dcost=1e-6`` a lane
    near the threshold turns on its last bits and the poorly observed
    points amplify them: on one CPU the scaled runs part from the unscaled
    one by 0 / 22 / 0 / 8 summed iterations and 7e-8 / 8e-9 / 4e-10 / 3e-3
    in the values (LM, Newton, dogleg, gradient descent)."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.bal import PT

    opts = nt.Options(iterator=iterator, rel_dcost=1e-6)
    fam = nt.family_name(PT)

    def run(device, scale=1.0):
        problem, _ = _view_case(device, torch.float64)
        problem.set_values({k: v * scale for k, v in problem.stacked_variables().items()})
        out = nt.optimize_singles(problem, opts, targets=PT)
        return out[fam], problem.stacked_variables()[fam].cpu().numpy()

    before = segment_sum.LAUNCHES
    iters, got = run(cuda)
    assert segment_sum.LAUNCHES > before
    cpu = [run(torch.device("cpu"), s) for s in (1.0, 1 + 2.0**-52, 1 - 2.0**-52)]
    want = cpu[0][1]

    def gap(v):
        return float(np.max(np.abs(v - want) / np.abs(want)))

    spread = max(gap(v) for _, v in cpu[1:])
    counts = [n for n, _ in cpu]
    width = max(counts) - min(counts)
    print(f"singles ({iterator}): card {iters} iterations, CPU {counts}; the card's largest "
          f"relative gap to the CPU run {gap(got):.3e}, the scaled CPU runs' {spread:.3e}")
    assert min(counts) - width <= iters <= max(counts) + width
    assert gap(got) <= 2 * spread


@pytest.mark.cuda
def test_runner_cache_captures_once(cuda):
    """A second ``nt.optimize`` of an unchanged problem on the card
    compiles and captures nothing and repeats a fresh run's trace."""
    import nllstpu_torch as nt
    from nllstpu_torch.core import optimize

    opts = nt.Options(max_iters=5, solver="schur", schur_family=nt.Euclidean(3),
                      max_time=float("inf"))
    problem, _ = _view_case(cuda)
    start = problem.stacked_variables()
    nt.optimize(problem, opts)
    problem.set_values(start)
    counts = optimize.COMPILES, optimize.CAPTURES
    again = nt.optimize(problem, opts)
    assert (optimize.COMPILES, optimize.CAPTURES) == counts
    assert again.costs == nt.optimize(_view_case(cuda)[0], opts).costs
