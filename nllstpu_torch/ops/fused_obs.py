"""Kernels B1, B2 and B8: Schur-system assembly in one pass over the
obs-major Jacobian (ports of ``nllstpu/ops/pallas/fused_obs.py:
fused_obs_all_pm``, ``fused_obs_all_pm_into`` and ``fused_obs_leg_pm``).

B1 and B8 take one bucket of a bundle-adjustment batch, K-major like the
TPU kernels:

    jac [n, S, K, L]   g0 [S, K, L]   d1m, d2m [K, L]   vc [K, L] int32

with ``d1m = ρ′·mask``, ``d2m = 2ρ″·mask`` and ``vc`` the slot's camera
column (``n_r``, the dustbin, for pad slots and fixed cameras); any
strides (the main path hands over landmark-major views of its batch).  B1
also takes the camera side's tables (:func:`camera_order`): ``cpos [K, L]
int32``, each slot's row in the camera-sorted order of the batch's
non-dustbin slots (−1 for a dustbin slot), and ``cstarts [n_r + 1]``,
each camera's run of that order.  B1 (``fused_obs_all``) takes the
uniform single-bucket layout and returns

    h_ll [dl, dl, L]                 Σ ρ′JₑᵀJₑ + 2ρ″g₀ₑg₀ₑᵀ
    g_l  [dl, L]                     Σ ρ′g₀ₑ
    w    [L, dl, n_r·dr_s]           ρ′JᵣᵀJₑ + 2ρ″g₀ᵣg₀ₑᵀ at the camera column
    ab   [n_r, npairs + dr_s]        per-camera a_rr upper triangle, then b_r

in two stages: the kernel writes each slot's ``npairs + dr_s`` camera
values to row ``cpos`` of a workspace, then kernel B6 (``segment_sum.py``)
sums the camera runs, every addition in a fixed order, as the TPU kernel
adds its tiles' contributions in grid order.  So B1 gives the same bits on
every launch.

B2 (``fused_obs_all_into``) takes a whole degree-bucketed batch in its
column order, ``jac [n, S, B]``, ``g0 [S, B]``, ``d1m``, ``d2m``, ``vc``,
``cpos [B]``, and its compile-time :class:`SlotTables` (each landmark's
real columns, the chunk bucket's and the class bucket's together, and the
work list of one launch).  It ADDS each landmark's h_ll and g_l into
full-size buffers, writes each (landmark, camera) block of W, which the
caller zeroes once, and each real slot's camera row; the caller sums the
camera runs once.  The TPU kernel runs once per bucket; here one launch
covers the batch.

B8 (``fused_obs_leg``) is B1 without the camera side: it returns h_ll,
g_l and W only, for the dual-sorted route, whose camera-major leg sums
a_rr and b_r over camera runs.

W is in the standard basis, landmark-major — not the TPU kernels' p-major
layout, which existed for Mosaic's tiling.  On CUDA tensors the wrappers
launch the hand-written kernels (``csrc/fused_obs.cu``: a landmark's slots
spread over a group of lanes, every sum in a fixed order); on CPU tensors
they run the plain PyTorch versions, which take the same two stages.

Shapes: the JAX kernels take any (n residual rows, dr_s, dl), and so does
the CUDA source: two instances unrolled for the hot shapes (2, 6, 3) and
(2, 9, 3), and one for every other shape, whose lanes hold nothing sized
by the shape: each round a warp stages its slots in shared memory sized to
the shape (:func:`any_shape_plan`), its lanes take the round's W and
camera-row entries as items, and each landmark's lanes sum its h_ll/g_l
terms by a butterfly, 32 entries a chunk.  Its one limit is the
hardware's (:func:`kernel_takes`): a warp's 32 staged slots of n·S + S + 2
values, with a chunk's sums and its lists, must fit the 227 KB of shared
memory a block opts in to (:data:`SMEM_LIMIT`) — the counterpart of the
JAX route's VMEM fit.  One
instance was chosen over one per shape compiled at first use because the
library then stays one build of fixed sources (its cold build is set-up
time, ``Result.time_init``), and no new shape compiles inside a timed run
or a CUDA graph capture.  The route (``ops/schur.py:route_batches``) asks
:func:`kernel_takes` at compile time and sends any other batch to the
generic route.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from . import _build, segment_sum

#: Widest lane group of one landmark in B2's work list (a warp).
GROUP_MAX = 32
#: Warps a block of the any-shape instance where its shared memory holds
#: them (``kAnyWarps`` in the source).
ANY_WARPS = 4
#: Bytes of shared memory a block of the any-shape instance may take: the
#: 227 KB a block of an sm_90 card opts in to (``kSmemLimit``).
SMEM_LIMIT = 232_448

#: Number of kernel launches made by :func:`fused_obs_all_cuda` (B1).
LAUNCHES = 0
#: Number of kernel launches made by :func:`fused_obs_all_into_cuda` (B2).
INTO_LAUNCHES = 0
#: Number of kernel launches made by :func:`fused_obs_leg_cuda` (B8).
LEG_LAUNCHES = 0


class AnyPlan(NamedTuple):
    """Dynamic shared memory of the any-shape instance's block, bytes
    (``any_bytes`` in the source)."""

    stride: int  # values of one staged slot: n·S Jacobian columns, g0, ρ′, 2ρ″ (odd)
    chunk: int  # h_ll/g_l entries summed a chunk: min(dl(dl+1)/2 + dl, 32)
    warp_bytes: int  # a warp's 32 staged slots, a chunk's sums and the round's lists
    warps: int  # warps a block: ANY_WARPS, or as many as SMEM_LIMIT holds (0: none)
    block_bytes: int  # warps · warp_bytes


@functools.lru_cache(maxsize=None)
def any_shape_plan(n: int, dr_s: int, dl: int, dtype) -> AnyPlan:
    """The any-shape instance's shared memory at (n, dr_s, dl) in ``dtype``
    (B1, B2 and B8 alike), the host's mirror of the CUDA source's: a staged
    slot of ``n·S + S + 2`` values rounded up to odd (lanes on distinct
    slots hit distinct banks); per warp 32 such slots, the group sums of
    one chunk of h_ll/g_l entries for up to 32 landmarks, and the round's
    W leaders (8 + 4 bytes), camera rows (8 bytes) and the chunk's entry
    codes (4 bytes); up to :data:`ANY_WARPS` warps a block within
    :data:`SMEM_LIMIT`.  The source opts the kernel in at
    :data:`SMEM_LIMIT`, the largest plan."""
    elt = torch.empty((), dtype=dtype).element_size()
    s = dr_s + dl
    stride = (n * s + s + 2) | 1
    chunk = min(dl * (dl + 1) // 2 + dl, 32)
    warp = 32 * (stride + chunk) * elt + 32 * (8 + 4 + 8 + 4)
    warps = min(ANY_WARPS, SMEM_LIMIT // warp)
    return AnyPlan(stride, chunk, warp, warps, warps * warp)


class SlotTables(NamedTuple):
    """Kernel B2's compile-time tables over a batch's columns."""

    slots: Any  # int32 [n_slots]: each landmark's columns in order; ~col repeats a camera
    starts: Any  # int32 [L + 1]: landmark l owns slots starts[l] .. starts[l+1] − 1
    work: Any  # int32 [n_work, 3]: (first landmark, landmarks, log2 of the lane group)


def slot_tables(lid, vc, n_landmarks: int, n_r: int) -> SlotTables:
    """Host :class:`SlotTables` of a batch whose column ``c`` holds an
    observation of landmark ``lid[c]`` (``n_landmarks`` for a pad column)
    by camera column ``vc[c]`` (``n_r``, the dustbin, adds no W block).
    Each landmark's slots are its columns in column order; a slot whose
    real camera appeared earlier in the list is stored as ``~column`` (it
    adds to that block).  The work list gives a landmark of d slots a group
    of G lanes, G the power of two at or above d, at most
    :data:`GROUP_MAX`, and packs ``GROUP_MAX / G`` consecutive landmarks of
    one G into an item."""
    lid, vc = np.asarray(lid), np.asarray(vc)
    L = n_landmarks
    cols = np.nonzero(lid < L)[0]
    order = cols[np.argsort(lid[cols], kind="stable")]
    lsort = lid[order].astype(np.int64)
    counts = np.bincount(lsort, minlength=L)
    starts = np.concatenate([[0], np.cumsum(counts)])
    v = vc[order]
    real = (v >= 0) & (v < n_r)
    key = lsort * (n_r + 1) + np.where(real, v, n_r)
    repeat = np.ones(order.shape[0], dtype=bool)
    repeat[np.unique(key, return_index=True)[1]] = False
    slots = np.where(repeat & real, ~order, order)
    ids = np.nonzero(counts > 0)[0]
    lg2 = np.ceil(np.log2(np.minimum(counts[ids], GROUP_MAX))).astype(np.int64)
    brk = np.ones(ids.shape[0], dtype=bool)
    brk[1:] = (np.diff(ids) != 1) | (np.diff(lg2) != 0)
    run_head = np.nonzero(brk)[0]
    run = np.cumsum(brk) - 1
    rank = np.arange(ids.shape[0]) - run_head[run]
    left = np.diff(np.append(run_head, ids.shape[0]))[run] - rank
    per = GROUP_MAX >> lg2
    head = rank % per == 0
    work = np.stack([ids[head], np.minimum(per, left)[head], lg2[head]], axis=1)
    return SlotTables(
        slots.astype(np.int32), starts.astype(np.int32), work.astype(np.int32).reshape(-1, 3)
    )


def camera_order(rvid, n_r: int):
    """Host tables of the camera side over a batch's columns ``rvid [B]``
    (camera column per slot, ``n_r`` for the dustbin): ``(cpos [B],
    cstarts [n_r + 1])``, int32.  ``cpos`` is each non-dustbin column's
    row in the order sorted by camera, stable within a camera, −1 for a
    dustbin column; camera ``v`` owns rows ``cstarts[v] .. cstarts[v+1] −
    1``."""
    rvid = np.asarray(rvid)
    real = np.nonzero((rvid >= 0) & (rvid < n_r))[0]
    order = real[np.argsort(rvid[real], kind="stable")]
    cpos = np.full(rvid.shape[0], -1, dtype=np.int32)
    cpos[order] = np.arange(order.shape[0], dtype=np.int32)
    counts = np.bincount(rvid[real], minlength=n_r)
    return cpos, np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def camera_tables(vc, n_r: int):
    """``(cpos [K, L], cstarts [n_r + 1])`` on ``vc``'s device for one
    bucket's tiles alone (columns in landmark-run order ``l·K + k``), by
    :func:`camera_order`; reads ``vc`` back to the host."""
    K, L = vc.shape
    cpos, cstarts = camera_order(vc.T.reshape(-1).cpu().numpy(), n_r)
    return (
        torch.as_tensor(np.ascontiguousarray(cpos.reshape(L, K).T), device=vc.device),
        torch.as_tensor(cstarts, device=vc.device),
    )


def zero_buffers(L: int, n_r: int, dr_s: int, dl: int, n_rows: int, dtype, device):
    """Zeroed ``(h_ll, g_l, w, rows)`` for ``L`` landmarks, ``n_r``
    cameras and ``n_rows`` camera rows: the buffers kernel B2 adds into
    and writes."""
    npairs = dr_s * (dr_s + 1) // 2
    return (
        torch.zeros(dl, dl, L, dtype=dtype, device=device),
        torch.zeros(dl, L, dtype=dtype, device=device),
        torch.zeros(L, dl, n_r * dr_s, dtype=dtype, device=device),
        torch.zeros(n_rows, npairs + dr_s, dtype=dtype, device=device),
    )


def _plain(jac, g0, d1m, d2m, vc, cpos, col, lid, h_ll, g_l, w, rows, n_r: int,
           dr_s: int, dl: int, e_start: int):
    """The plain assembly of the slots at flat columns ``col`` of
    landmarks ``lid`` (``jac [n, S, B]``, ``g0 [S, B]``, the rest ``[B]``):
    h_ll and g_l (unless None) and W added in place, camera rows written
    at ``cpos`` (none when ``rows`` is None)."""
    r_rows = [r for r in range(jac.shape[1]) if not (e_start <= r < e_start + dl)]
    jc, gc = jac[:, :, col], g0[:, col]
    je, jr = jc[:, e_start : e_start + dl], jc[:, r_rows]  # [n, dl | dr_s, M]
    ge, gr = gc[e_start : e_start + dl], gc[r_rows]
    a1, a2, v = d1m[col], d2m[col], vc[col]
    if h_ll is not None:
        h_ll.index_add_(
            2, lid, torch.einsum("nam,nbm->abm", je, je) * a1 + a2 * ge[:, None] * ge[None, :]
        )
        g_l.index_add_(1, lid, ge * a1)
    # Coupling blocks [dr_s, dl, M] added at column v·dr_s + p of row
    # (lid, d); dustbin slots add an exact zero to camera 0.
    valid = (v >= 0) & (v < n_r)
    cam = torch.where(valid, v, torch.zeros_like(v)).long()
    we = torch.einsum("npm,ndm->pdm", jr, je) * a1 + a2 * gr[:, None] * ge[None, :]
    wc = n_r * dr_s
    dev = jac.device
    flat = (
        (lid[None, None, :] * dl + torch.arange(dl, device=dev)[None, :, None]) * wc
        + cam[None, None, :] * dr_s
        + torch.arange(dr_s, device=dev)[:, None, None]
    )  # [dr_s, dl, M]
    w.view(-1).index_add_(0, flat.reshape(-1), torch.where(valid, we, 0.0).reshape(-1))
    if rows is None:
        return
    pi, qi = np.triu_indices(dr_s)  # the kernel's a_rr row order
    a_rows = (
        torch.einsum("npm,nqm->pqm", jr, jr) * a1 + a2 * gr[:, None] * gr[None, :]
    )[pi, qi]  # [npairs, M]
    vals = torch.cat([a_rows, gr * a1], dim=0)  # [npairs + dr_s, M]
    cp = cpos[col]
    keep = cp >= 0
    rows[cp[keep].long()] = vals[:, keep].T


def _tile_plain(jac, g0, d1m, d2m, vc, cpos, n_r, dr_s, dl, e_start, n_rows):
    """B1's and B8's plain version over one ``[K, L]`` tile: zeroed
    buffers, h_ll and g_l summed over the tile's K slots, W added and the
    camera rows written (none when ``cpos`` is None) per slot."""
    n, s, k, L = jac.shape
    h_ll, g_l, w, rows = zero_buffers(L, n_r, dr_s, dl, n_rows, jac.dtype, jac.device)
    je, ge = jac[:, e_start : e_start + dl], g0[e_start : e_start + dl]  # [n, dl, K, L]
    h_ll += (
        torch.einsum("nakl,nbkl->abkl", je, je) * d1m + d2m * ge[:, None] * ge[None, :]
    ).sum(dim=2)
    g_l += (ge * d1m).sum(dim=1)
    # W and the camera rows per slot, in landmark order (column l·K + k).
    flat = (
        jac.transpose(2, 3).reshape(n, s, k * L), g0.transpose(1, 2).reshape(s, k * L),
        *(t.T.reshape(k * L) for t in (d1m, d2m, vc)),
        None if cpos is None else cpos.T.reshape(k * L),
    )
    col = torch.arange(k * L, device=jac.device)
    lid = torch.arange(L, device=jac.device).repeat_interleave(k)
    _plain(*flat, col, lid, None, None, w, None if cpos is None else rows,
           n_r, dr_s, dl, e_start)
    return h_ll, g_l, w, rows


def fused_obs_all_into_reference(jac, g0, d1m, d2m, vc, cpos, slots: SlotTables,
                                 h_ll, g_l, w, rows, n_r: int, dr_s: int,
                                 dl: int, e_start: int):
    """Plain PyTorch version of kernel B2 (same contract): adds each
    landmark's h_ll and g_l over its slots in ``slots``, adds its W blocks
    into the zeroed W and writes its slots' camera rows at ``cpos``."""
    e = slots.slots.long()
    col = torch.where(e < 0, ~e, e)
    L = slots.starts.shape[0] - 1
    lid = torch.arange(L, device=jac.device).repeat_interleave(
        (slots.starts[1:] - slots.starts[:-1]).long()
    )
    _plain(jac, g0, d1m, d2m, vc, cpos, col, lid, h_ll, g_l, w, rows, n_r, dr_s, dl, e_start)


def fused_obs_all_reference(jac, g0, d1m, d2m, vc, cpos, cstarts, n_r: int,
                            dr_s: int, dl: int, e_start: int):
    """Plain PyTorch version of kernel B1 (same contract): the tile's
    blocks into zeroed buffers, then B6's plain version over the camera
    runs."""
    k, L = vc.shape
    h_ll, g_l, w, rows = _tile_plain(jac, g0, d1m, d2m, vc, cpos, n_r, dr_s, dl, e_start, k * L)
    return h_ll, g_l, w, segment_sum.segment_block_sum_reference(rows, cstarts)


def fused_obs_leg_reference(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int,
                            dl: int, e_start: int):
    """Plain PyTorch version of kernel B8: ``(h_ll [dl, dl, L], g_l [dl,
    L], w [L, dl, n_r·dr_s])``, B1's plain version without the camera
    side."""
    return _tile_plain(jac, g0, d1m, d2m, vc, None, n_r, dr_s, dl, e_start, 0)[:3]


def kernel_takes(n: int, dr_s: int, dl: int, dtype) -> bool:
    """Whether kernels B1, B2 and B8 take a batch of ``n`` residual rows,
    ``dr_s`` camera and ``dl`` landmark dof in ``dtype``: any shape whose
    warp region fits a block's shared memory (:func:`any_shape_plan`; the
    two unrolled shapes fit), asked by the route at compile time on every
    device."""
    return (dtype in (torch.float32, torch.float64) and min(n, dr_s, dl) >= 1
            and any_shape_plan(n, dr_s, dl, dtype).warps >= 1)


def refusal(n: int, dr_s: int, dl: int, dtype) -> str:
    """Why kernels B1, B2 and B8 do not take the shape, in words naming
    the bytes (the route's ``generic_why`` and the wrappers' error)."""
    if dtype not in (torch.float32, torch.float64) or min(n, dr_s, dl) < 1:
        return f"they take float32 and float64 at n, dr_s, dl ≥ 1, not {dtype}"
    plan = any_shape_plan(n, dr_s, dl, dtype)
    return (f"a warp's 32 staged slots of {plan.stride} values with its sums and lists take "
            f"{plan.warp_bytes} bytes of shared memory, past the {SMEM_LIMIT} a block holds")


def _check_shape(name, n, s, dr_s, dl, e_start, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    if s != dr_s + dl or not 0 <= e_start <= dr_s:
        raise ValueError(f"{name}: S={s} is not dr_s + dl = {dr_s} + {dl}, or the landmark's "
                         f"rows from e_start={e_start} are not inside it")
    if not kernel_takes(n, dr_s, dl, dtype):
        raise ValueError(
            f"{name}: n={n}, dr_s={dr_s}, dl={dl}: {refusal(n, dr_s, dl, dtype)}; the compile "
            "sends such a batch to the generic route"
        )


def _check_small(name, ref, tensors, shape):
    """``tensors``: ``(name, tensor, is_int)``; each must have ``shape``,
    ``ref``'s device, and int32 or ``ref``'s dtype."""
    for tname, t, is_int in tensors:
        if tuple(t.shape) != shape or t.device != ref.device:
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} {t.device}")
        if t.dtype != (torch.int32 if is_int else ref.dtype):
            raise TypeError(f"{name}: {tname} must be "
                            f"{'int32' if is_int else 'of jac dtype'}, got {t.dtype}")


def _tile_inputs(name, jac, g0, d1m, d2m, vc, dr_s, dl, e_start, cpos=None):
    """Validate one bucket's kernel inputs (and B1's ``cpos``); returns
    them with the strides the kernel reads them at, ``(jsn, jss, gss, sk,
    sl, gk, gl)``: the callers' own when every tensor but g0 shares jac's
    (K, L) strides, else those of contiguous copies.  The checks run on
    every launch, so the common case is one expression."""
    n, s, k, L = jac.shape
    out = [jac, g0, d1m, d2m, vc] if cpos is None else [jac, g0, d1m, d2m, vc, cpos]
    dt, dev = jac.dtype, jac.device
    if not (
        kernel_takes(n, dr_s, dl, dt) and s == dr_s + dl and 0 <= e_start <= dr_s
        and g0.shape == (s, k, L) and g0.dtype == dt and g0.device == dev
        and d1m.dtype == dt and d2m.dtype == dt and vc.dtype == torch.int32
        and (cpos is None or cpos.dtype == torch.int32)
        and all(t.shape == (k, L) and t.device == dev for t in out[2:])
    ):
        _check_shape(name, n, s, dr_s, dl, e_start, dt)
        small = [("d1m", d1m, False), ("d2m", d2m, False), ("vc", vc, True)]
        if cpos is not None:
            small.append(("cpos", cpos, True))
        _check_small(name, jac, small, (k, L))
        _check_small(name, jac, [("g0", g0, False)], (s, k, L))
    strides, gst = jac.stride(), g0.stride()
    sk, sl = strides[2:]
    if not (all(t.stride() == (sk, sl) for t in out[2:]) and min(strides + gst) > 0):
        out = [t.contiguous() for t in out]
        strides, gst, sk, sl = out[0].stride(), out[1].stride(), L, 1
    return out, (strides[0], strides[1], gst[0], sk, sl, gst[1], gst[2])


def _tile_outputs(L, n_r, dr_s, dl, dt, dev):
    """B1's and B8's ``(h_ll, g_l, w)``, uninitialised: the kernel writes
    every entry, W's zeros included."""
    return (torch.empty(dl, dl, L, dtype=dt, device=dev),
            torch.empty(dl, L, dtype=dt, device=dev),
            torch.empty(L, dl, n_r * dr_s, dtype=dt, device=dev))


def _lib_fn(base, dtype):
    lib = _build.library()
    return getattr(lib, f"{base}_{'f32' if dtype == torch.float32 else 'f64'}")


def fused_obs_all_cuda(jac, g0, d1m, d2m, vc, cpos, cstarts, n_r: int,
                       dr_s: int, dl: int, e_start: int):
    """Launch kernel B1 on CUDA tensors, then kernel B6 over its camera
    rows (same contract as the reference)."""
    global LAUNCHES
    (jac, g0, d1m, d2m, vc, cpos), strides = _tile_inputs(
        "fused_obs_all", jac, g0, d1m, d2m, vc, dr_s, dl, e_start, cpos
    )
    if tuple(cstarts.shape) != (n_r + 1,) or cstarts.device != jac.device:
        raise ValueError(f"fused_obs_all: cstarts {tuple(cstarts.shape)} {cstarts.device}")
    n, s, k, L = jac.shape
    npairs = dr_s * (dr_s + 1) // 2
    dt, dev = jac.dtype, jac.device
    h_ll, g_l, w = _tile_outputs(L, n_r, dr_s, dl, dt, dev)
    # A row for every slot: the rows past cstarts[n_r] (dustbin slots) are
    # left unwritten and B6 never reads them.
    rows = torch.empty(k * L, npairs + dr_s, dtype=dt, device=dev)
    code = _lib_fn("fused_obs_all", dt)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), cpos.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(),
        w.data_ptr(), rows.data_ptr(), n, s, k, L, n_r, k * L, dr_s, dl,
        e_start, *strides, _build.stream_ptr(dev),
    )
    _build.check(code, "fused_obs_all launch")
    LAUNCHES += 1
    return h_ll, g_l, w, segment_sum.segment_block_sum_cuda(rows, cstarts)


def fused_obs_all_into_cuda(jac, g0, d1m, d2m, vc, cpos, slots: SlotTables,
                            h_ll, g_l, w, rows, n_r: int, dr_s: int, dl: int,
                            e_start: int):
    """Launch kernel B2 on CUDA tensors (same contract as the reference).
    The buffers are updated in place, so they must be contiguous."""
    global INTO_LAUNCHES
    n, s, b = jac.shape
    _check_shape("fused_obs_all_into", n, s, dr_s, dl, e_start, jac.dtype)
    _check_small("fused_obs_all_into", jac, [("g0", g0, False)], (s, b))
    _check_small(
        "fused_obs_all_into", jac,
        [("d1m", d1m, False), ("d2m", d2m, False), ("vc", vc, True), ("cpos", cpos, True)],
        (b,),
    )
    lt = w.shape[0]
    npairs = dr_s * (dr_s + 1) // 2
    for tname, t, shape in (
        ("h_ll", h_ll, (dl, dl, lt)), ("g_l", g_l, (dl, lt)),
        ("w", w, (lt, dl, n_r * dr_s)), ("rows", rows, (rows.shape[0], npairs + dr_s)),
    ):
        if (tuple(t.shape) != shape or t.dtype != jac.dtype
                or t.device != jac.device or not t.is_contiguous()):
            raise ValueError(
                f"fused_obs_all_into: buffer {tname} {tuple(t.shape)} "
                f"{t.dtype} {t.device} (contiguous {t.is_contiguous()}) does "
                f"not match {shape} {jac.dtype} {jac.device}"
            )
    n_work = slots.work.shape[0]
    for tname, t, shape in (("starts", slots.starts, (lt + 1,)),
                            ("work", slots.work, (n_work, 3)),
                            ("slots", slots.slots, (slots.slots.shape[0],))):
        if (tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != jac.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_obs_all_into: table {tname} {tuple(t.shape)} "
                             f"{t.dtype} {t.device} does not match {shape}")
    # The kernel reads a column at jac's and the small inputs' offset c and
    # at g0's c·gk: any strides, but a column must be unit-stride in jac.
    if jac.stride(2) != 1 or min(jac.stride() + g0.stride()) < 0:
        jac = jac.contiguous()
    d1m, d2m, vc, cpos = (t.contiguous() for t in (d1m, d2m, vc, cpos))
    code = _lib_fn("fused_obs_all_into", jac.dtype)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), cpos.data_ptr(), slots.slots.data_ptr(),
        slots.starts.data_ptr(), slots.work.data_ptr(), h_ll.data_ptr(),
        g_l.data_ptr(), w.data_ptr(), rows.data_ptr(), n, s, n_work, lt, n_r,
        rows.shape[0], dr_s, dl, e_start, jac.stride(0), jac.stride(1),
        g0.stride(0), g0.stride(1), _build.stream_ptr(jac.device),
    )
    _build.check(code, "fused_obs_all_into launch")
    INTO_LAUNCHES += 1


def fused_obs_leg_cuda(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int, dl: int,
                       e_start: int):
    """Launch kernel B8 on CUDA tensors (same contract as the reference)."""
    global LEG_LAUNCHES
    (jac, g0, d1m, d2m, vc), strides = _tile_inputs(
        "fused_obs_leg", jac, g0, d1m, d2m, vc, dr_s, dl, e_start
    )
    n, s, k, L = jac.shape
    dt, dev = jac.dtype, jac.device
    h_ll, g_l, w = _tile_outputs(L, n_r, dr_s, dl, dt, dev)
    code = _lib_fn("fused_obs_leg", dt)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), None, h_ll.data_ptr(), g_l.data_ptr(), w.data_ptr(), None,
        n, s, k, L, n_r, 0, dr_s, dl, e_start, *strides, _build.stream_ptr(dev),
    )
    _build.check(code, "fused_obs_leg launch")
    LEG_LAUNCHES += 1
    return h_ll, g_l, w


def fused_obs_leg(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int, dl: int,
                  e_start: int):
    """Kernel B8 on CUDA tensors, its plain version on CPU tensors."""
    if jac.is_cuda:
        return fused_obs_leg_cuda(jac, g0, d1m, d2m, vc, n_r, dr_s, dl, e_start)
    if jac.device.type != "cpu":
        raise ValueError(f"fused_obs_leg: unsupported device {jac.device}")
    return fused_obs_leg_reference(jac, g0, d1m, d2m, vc, n_r, dr_s, dl, e_start)


def fused_obs_all(jac, g0, d1m, d2m, vc, cpos, cstarts, n_r: int, dr_s: int,
                  dl: int, e_start: int):
    """Kernel B1 (with B6 over its camera rows) on CUDA tensors, its plain
    version on CPU tensors."""
    args = (jac, g0, d1m, d2m, vc, cpos, cstarts, n_r, dr_s, dl, e_start)
    if jac.is_cuda:
        return fused_obs_all_cuda(*args)
    if jac.device.type != "cpu":
        raise ValueError(f"fused_obs_all: unsupported device {jac.device}")
    return fused_obs_all_reference(*args)


def fused_obs_all_into(jac, g0, d1m, d2m, vc, cpos, slots: SlotTables, h_ll,
                       g_l, w, rows, n_r: int, dr_s: int, dl: int,
                       e_start: int):
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors."""
    args = (jac, g0, d1m, d2m, vc, cpos, slots, h_ll, g_l, w, rows, n_r,
            dr_s, dl, e_start)
    if jac.is_cuda:
        return fused_obs_all_into_cuda(*args)
    if jac.device.type != "cpu":
        raise ValueError(f"fused_obs_all_into: unsupported device {jac.device}")
    return fused_obs_all_into_reference(*args)
