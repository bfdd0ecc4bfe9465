"""Kernels B1, B2 and B8: Schur-system assembly in one pass over the
obs-major Jacobian (ports of ``nllstpu/ops/pallas/fused_obs.py:
fused_obs_all_pm``, ``fused_obs_all_pm_into`` and ``fused_obs_leg_pm``).

All take one bucket of a bundle-adjustment batch, K-major like the TPU
kernels:

    jac [n, S, K, L]   g0 [S, K, L]   d1m, d2m [K, L]   vc [K, L] int32

with ``d1m = ρ′·mask``, ``d2m = 2ρ″·mask`` and ``vc`` the slot's camera
column (``n_r``, the dustbin, for pad slots and fixed cameras).  B1 and B2
also take the camera side's tables (:func:`camera_order`): ``cpos [K, L]
int32``, each slot's row in the camera-sorted order of the batch's
non-dustbin slots (−1 for a dustbin slot), and ``cstarts [n_r + 1]``, each
camera's run of that order.  B1 (``fused_obs_all``) takes the uniform
single-bucket layout and returns

    h_ll [dl, dl, L]                 Σ ρ′JₑᵀJₑ + 2ρ″g₀ₑg₀ₑᵀ
    g_l  [dl, L]                     Σ ρ′g₀ₑ
    w    [L, dl, n_r·dr_s]           ρ′JᵣᵀJₑ + 2ρ″g₀ᵣg₀ₑᵀ at the camera column
    ab   [n_r, npairs + dr_s]        per-camera a_rr upper triangle, then b_r

in two stages: the kernel writes each slot's ``npairs + dr_s`` camera
values to row ``cpos`` of a workspace, then kernel B6 (``segment_sum.py``)
sums the camera runs, every addition in a fixed order, as the TPU kernel
adds its tiles' contributions in grid order.  So B1 gives the same bits on
every launch.

B2 (``fused_obs_all_into``) takes one degree bucket of a skewed layout: it
ADDS the bucket's h_ll, g_l and W contributions in place into full-size
buffers, the bucket's landmark ``l`` going to row ``l_base + l``, and
writes its slots' camera rows into the batch's workspace ``rows
[n_slots, npairs + dr_s]``.  Chunk buckets revisit the heavy landmarks of
a later bucket, so nothing is overwritten but the camera rows, each of
which one slot owns; W is zeroed once per assembly by the caller, which
sums the camera runs once, after the last bucket.

B8 (``fused_obs_leg``) is B1 without the camera side: it returns h_ll,
g_l and W only, for the dual-sorted route, whose camera-major leg sums
a_rr and b_r over camera runs.

W is in the standard basis, landmark-major — not the TPU kernels' p-major
layout, which existed for Mosaic's tiling.  On CUDA tensors the wrappers
launch the hand-written kernels (``csrc/fused_obs.cu``); on CPU tensors they
run the plain PyTorch versions, which take the same two stages.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, segment_sum

#: (n residual rows, dr_s, dl) instantiated in csrc/fused_obs.cu.
CUDA_SHAPES = ((2, 6, 3), (2, 9, 3))

#: Number of kernel launches made by :func:`fused_obs_all_cuda` (B1).
LAUNCHES = 0
#: Number of kernel launches made by :func:`fused_obs_all_into_cuda` (B2).
INTO_LAUNCHES = 0
#: Number of kernel launches made by :func:`fused_obs_leg_cuda` (B8).
LEG_LAUNCHES = 0


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


def fused_obs_all_into_reference(jac, g0, d1m, d2m, vc, cpos, h_ll, g_l, w,
                                 rows, l_base: int, n_r: int, dr_s: int,
                                 dl: int, e_start: int):
    """Plain PyTorch version of kernel B2 (same contract): adds one
    bucket's h_ll, g_l and W contributions in place and writes its slots'
    camera rows at ``cpos`` (no camera side when ``rows`` is None, B8's)."""
    n, s, k, L = jac.shape
    dev = jac.device
    r_rows = [r for r in range(s) if not (e_start <= r < e_start + dl)]
    je = jac[:, e_start : e_start + dl]  # [n, dl, K, L]
    jr = jac[:, r_rows]  # [n, dr_s, K, L]
    ge = g0[e_start : e_start + dl]
    gr = g0[r_rows]
    h_ll[:, :, l_base : l_base + L] += (
        torch.einsum("nakl,nbkl->abkl", je, je) * d1m
        + d2m * ge[:, None] * ge[None, :]
    ).sum(dim=2)
    g_l[:, l_base : l_base + L] += (ge * d1m).sum(dim=1)
    # Coupling rows [dr_s, dl, K, L] added at column vc·dr_s + p of row
    # (l_base + l, d); dustbin slots add an exact zero to camera 0.
    valid = (vc >= 0) & (vc < n_r)
    cam = torch.where(valid, vc, torch.zeros_like(vc)).long()  # [K, L]
    we = torch.einsum("npkl,ndkl->pdkl", jr, je) * d1m + d2m * gr[:, None] * ge[None, :]
    wc = n_r * dr_s
    lidx = torch.arange(l_base, l_base + L, device=dev)
    col = cam[None, None] * dr_s + torch.arange(dr_s, device=dev)[:, None, None, None]
    flat = (
        (lidx[None, None, None, :] * dl + torch.arange(dl, device=dev)[None, :, None, None])
        * wc
        + col
    )  # [dr_s, dl, K, L]
    w.view(-1).index_add_(0, flat.reshape(-1), torch.where(valid, we, 0.0).reshape(-1))
    if rows is None:
        return
    pi, qi = np.triu_indices(dr_s)  # the kernel's a_rr row order
    a_rows = (
        torch.einsum("npkl,nqkl->pqkl", jr, jr) * d1m
        + d2m * gr[:, None] * gr[None, :]
    )[pi, qi]  # [npairs, K, L]
    vals = torch.cat([a_rows, gr * d1m], dim=0)  # [npairs + dr_s, K, L]
    keep = cpos >= 0
    rows[cpos[keep].long()] = vals[:, keep].T


def fused_obs_all_reference(jac, g0, d1m, d2m, vc, cpos, cstarts, n_r: int,
                            dr_s: int, dl: int, e_start: int):
    """Plain PyTorch version of kernel B1 (same contract): B2's plain
    version into zeroed buffers, then B6's plain version over the camera
    runs."""
    k, L = vc.shape
    h_ll, g_l, w, rows = zero_buffers(L, n_r, dr_s, dl, k * L, jac.dtype, jac.device)
    fused_obs_all_into_reference(
        jac, g0, d1m, d2m, vc, cpos, h_ll, g_l, w, rows, 0, n_r, dr_s, dl, e_start
    )
    return h_ll, g_l, w, segment_sum.segment_block_sum_reference(rows, cstarts)


def fused_obs_leg_reference(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int,
                            dl: int, e_start: int):
    """Plain PyTorch version of kernel B8: ``(h_ll [dl, dl, L], g_l [dl,
    L], w [L, dl, n_r·dr_s])``, B1's plain version without the camera
    side."""
    L = jac.shape[3]
    h_ll = torch.zeros(dl, dl, L, dtype=jac.dtype, device=jac.device)
    g_l = torch.zeros(dl, L, dtype=jac.dtype, device=jac.device)
    w = torch.zeros(L, dl, n_r * dr_s, dtype=jac.dtype, device=jac.device)
    fused_obs_all_into_reference(
        jac, g0, d1m, d2m, vc, None, h_ll, g_l, w, None, 0, n_r, dr_s, dl, e_start
    )
    return h_ll, g_l, w


def _checked_inputs(name, jac, g0, d1m, d2m, vc, dr_s, dl, cpos=None):
    """Validate one bucket's kernel inputs (and B1/B2's ``cpos``); returns
    them contiguous."""
    n, s, k, L = jac.shape
    if (n, dr_s, dl) not in CUDA_SHAPES or s != dr_s + dl:
        raise ValueError(
            f"{name}: no kernel instance for n={n}, dr_s={dr_s}, dl={dl}"
            f" (have {CUDA_SHAPES})"
        )
    if jac.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {jac.dtype}")
    ints = (("vc", vc),) if cpos is None else (("vc", vc), ("cpos", cpos))
    for tname, t, shape in (
        ("g0", g0, (s, k, L)), ("d1m", d1m, (k, L)), ("d2m", d2m, (k, L)),
        *((tn, t, (k, L)) for tn, t in ints),
    ):
        if tuple(t.shape) != shape or t.device != jac.device:
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} {t.device}")
    for tname, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {tname} must be int32")
    for t in (g0, d1m, d2m):
        if t.dtype != jac.dtype:
            raise TypeError(f"{name}: mixed float dtypes")
    out = (jac, g0, d1m, d2m, vc) + (() if cpos is None else (cpos,))
    return tuple(t.contiguous() for t in out)


def _lib_fn(base, dtype):
    lib = _build.library()
    return getattr(lib, f"{base}_{'f32' if dtype == torch.float32 else 'f64'}")


def fused_obs_all_cuda(jac, g0, d1m, d2m, vc, cpos, cstarts, n_r: int,
                       dr_s: int, dl: int, e_start: int):
    """Launch kernel B1 on CUDA tensors, then kernel B6 over its camera
    rows (same contract as the reference)."""
    global LAUNCHES
    jac, g0, d1m, d2m, vc, cpos = _checked_inputs(
        "fused_obs_all", jac, g0, d1m, d2m, vc, dr_s, dl, cpos
    )
    if tuple(cstarts.shape) != (n_r + 1,) or cstarts.device != jac.device:
        raise ValueError(f"fused_obs_all: cstarts {tuple(cstarts.shape)} {cstarts.device}")
    n, s, k, L = jac.shape
    npairs = dr_s * (dr_s + 1) // 2
    dt, dev = jac.dtype, jac.device
    h_ll = torch.empty(dl, dl, L, dtype=dt, device=dev)
    g_l = torch.empty(dl, L, dtype=dt, device=dev)
    w = torch.zeros(L, dl, n_r * dr_s, dtype=dt, device=dev)
    # A row for every slot: the rows past cstarts[n_r] (dustbin slots) are
    # left unwritten and B6 never reads them.
    rows = torch.empty(k * L, npairs + dr_s, dtype=dt, device=dev)
    code = _lib_fn("fused_obs_all", dt)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), cpos.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(),
        w.data_ptr(), rows.data_ptr(), n, s, k, L, n_r, k * L, dr_s, dl,
        e_start, _build.stream_ptr(dev),
    )
    _build.check(code, "fused_obs_all launch")
    LAUNCHES += 1
    return h_ll, g_l, w, segment_sum.segment_block_sum_cuda(rows, cstarts)


def fused_obs_all_into_cuda(jac, g0, d1m, d2m, vc, cpos, h_ll, g_l, w, rows,
                            l_base: int, n_r: int, dr_s: int, dl: int,
                            e_start: int):
    """Launch kernel B2 on CUDA tensors (same contract as the reference).
    The buffers are updated in place, so they must be contiguous."""
    global INTO_LAUNCHES
    jac, g0, d1m, d2m, vc, cpos = _checked_inputs(
        "fused_obs_all_into", jac, g0, d1m, d2m, vc, dr_s, dl, cpos
    )
    n, s, k, L = jac.shape
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
    if not 0 <= l_base <= lt - L:
        raise ValueError(
            f"fused_obs_all_into: landmarks {l_base}..{l_base + L - 1} "
            f"outside the buffers' {lt}"
        )
    code = _lib_fn("fused_obs_all_into", jac.dtype)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), cpos.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(),
        w.data_ptr(), rows.data_ptr(), n, s, k, L, lt, l_base, n_r,
        rows.shape[0], dr_s, dl, e_start, _build.stream_ptr(jac.device),
    )
    _build.check(code, "fused_obs_all_into launch")
    INTO_LAUNCHES += 1


def fused_obs_leg_cuda(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int, dl: int,
                       e_start: int):
    """Launch kernel B8 on CUDA tensors (same contract as the reference)."""
    global LEG_LAUNCHES
    jac, g0, d1m, d2m, vc = _checked_inputs(
        "fused_obs_leg", jac, g0, d1m, d2m, vc, dr_s, dl
    )
    n, s, k, L = jac.shape
    dt, dev = jac.dtype, jac.device
    h_ll = torch.empty(dl, dl, L, dtype=dt, device=dev)
    g_l = torch.empty(dl, L, dtype=dt, device=dev)
    w = torch.zeros(L, dl, n_r * dr_s, dtype=dt, device=dev)
    code = _lib_fn("fused_obs_leg", dt)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(), w.data_ptr(),
        n, s, k, L, n_r, dr_s, dl, e_start, _build.stream_ptr(dev),
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


def fused_obs_all_into(jac, g0, d1m, d2m, vc, cpos, h_ll, g_l, w, rows,
                       l_base: int, n_r: int, dr_s: int, dl: int,
                       e_start: int):
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors."""
    args = (jac, g0, d1m, d2m, vc, cpos, h_ll, g_l, w, rows, l_base, n_r,
            dr_s, dl, e_start)
    if jac.is_cuda:
        return fused_obs_all_into_cuda(*args)
    if jac.device.type != "cpu":
        raise ValueError(f"fused_obs_all_into: unsupported device {jac.device}")
    return fused_obs_all_into_reference(*args)
