"""Kernels B1, B2 and B8: Schur-system assembly in one pass over the
obs-major Jacobian (ports of ``nllstpu/ops/pallas/fused_obs.py:
fused_obs_all_pm``, ``fused_obs_all_pm_into`` and ``fused_obs_leg_pm``).

Both take one bucket of a bundle-adjustment batch, K-major like the TPU
kernels:

    jac [n, S, K, L]   g0 [S, K, L]   d1m, d2m [K, L]   vc [K, L] int32

with ``d1m = ρ′·mask``, ``d2m = 2ρ″·mask`` and ``vc`` the slot's camera
column (``n_r``, the dustbin, for pad slots and fixed cameras).  B1
(``fused_obs_all``) takes the uniform single-bucket layout and returns

    h_ll [dl, dl, L]                 Σ ρ′JₑᵀJₑ + 2ρ″g₀ₑg₀ₑᵀ
    g_l  [dl, L]                     Σ ρ′g₀ₑ
    w    [L, dl, n_r·dr_s]           ρ′JᵣᵀJₑ + 2ρ″g₀ᵣg₀ₑᵀ at the camera column
    ab   [npairs + dr_s, n_r]        per-camera a_rr upper triangle, then b_r

B2 (``fused_obs_all_into``) takes one degree bucket of a skewed layout and
ADDS the same four contributions in place into full-size buffers, the
bucket's landmark ``l`` going to row ``l_base + l`` of h_ll, g_l and W.
Chunk buckets revisit the heavy landmarks of a later bucket, so nothing is
overwritten, and W is zeroed once per assembly by the caller.

B8 (``fused_obs_leg``) is B1 without the camera side: it returns h_ll,
g_l and W only, for the dual-sorted route, whose camera-major leg sums
a_rr and b_r over camera runs.  With no shared camera sums it needs no
atomics, and its outputs have the same bits on every launch.

W is in the standard basis, landmark-major — not the TPU kernels' p-major
layout, which existed for Mosaic's tiling.  On CUDA tensors the wrappers
launch the hand-written kernels (``csrc/fused_obs.cu``); on CPU tensors they
run the plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

#: (n residual rows, dr_s, dl) instantiated in csrc/fused_obs.cu.
CUDA_SHAPES = ((2, 6, 3), (2, 9, 3))

#: Number of kernel launches made by :func:`fused_obs_all_cuda` (B1).
LAUNCHES = 0
#: Number of kernel launches made by :func:`fused_obs_all_into_cuda` (B2).
INTO_LAUNCHES = 0
#: Number of kernel launches made by :func:`fused_obs_leg_cuda` (B8).
LEG_LAUNCHES = 0


def zero_buffers(L: int, n_r: int, dr_s: int, dl: int, dtype, device):
    """Zeroed ``(h_ll, g_l, w, ab)`` for ``L`` landmarks and ``n_r``
    cameras: the buffers kernel B2 adds into."""
    npairs = dr_s * (dr_s + 1) // 2
    return (
        torch.zeros(dl, dl, L, dtype=dtype, device=device),
        torch.zeros(dl, L, dtype=dtype, device=device),
        torch.zeros(L, dl, n_r * dr_s, dtype=dtype, device=device),
        torch.zeros(npairs + dr_s, n_r, dtype=dtype, device=device),
    )


def fused_obs_all_into_reference(jac, g0, d1m, d2m, vc, h_ll, g_l, w, ab,
                                 l_base: int, n_r: int, dr_s: int, dl: int,
                                 e_start: int):
    """Plain PyTorch version of kernel B2 (same contract): adds one
    bucket's h_ll, g_l, W and ab contributions in place (no camera side
    when ``ab`` is None, B8's)."""
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
    if ab is None:
        return
    pi, qi = np.triu_indices(dr_s)  # the kernel's a_rr row order
    a_rows = (
        torch.einsum("npkl,nqkl->pqkl", jr, jr) * d1m
        + d2m * gr[:, None] * gr[None, :]
    )[pi, qi]  # [npairs, K, L]
    rows = torch.cat([a_rows, gr * d1m], dim=0)
    ab.index_add_(1, cam.reshape(-1), torch.where(valid, rows, 0.0).reshape(len(pi) + dr_s, -1))


def fused_obs_all_reference(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int,
                            dl: int, e_start: int):
    """Plain PyTorch version of kernel B1 (same contract): B2's plain
    version into zeroed buffers."""
    h_ll, g_l, w, ab = zero_buffers(jac.shape[3], n_r, dr_s, dl, jac.dtype, jac.device)
    fused_obs_all_into_reference(
        jac, g0, d1m, d2m, vc, h_ll, g_l, w, ab, 0, n_r, dr_s, dl, e_start
    )
    return h_ll, g_l, w, ab


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
        jac, g0, d1m, d2m, vc, h_ll, g_l, w, None, 0, n_r, dr_s, dl, e_start
    )
    return h_ll, g_l, w


def _checked_inputs(name, jac, g0, d1m, d2m, vc, dr_s, dl):
    """Validate one bucket's kernel inputs; returns them contiguous."""
    n, s, k, L = jac.shape
    if (n, dr_s, dl) not in CUDA_SHAPES or s != dr_s + dl:
        raise ValueError(
            f"{name}: no kernel instance for n={n}, dr_s={dr_s}, dl={dl}"
            f" (have {CUDA_SHAPES})"
        )
    if jac.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {jac.dtype}")
    for tname, t, shape in (
        ("g0", g0, (s, k, L)), ("d1m", d1m, (k, L)), ("d2m", d2m, (k, L)),
        ("vc", vc, (k, L)),
    ):
        if tuple(t.shape) != shape or t.device != jac.device:
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} {t.device}")
    if vc.dtype != torch.int32:
        raise TypeError(f"{name}: vc must be int32")
    for t in (g0, d1m, d2m):
        if t.dtype != jac.dtype:
            raise TypeError(f"{name}: mixed float dtypes")
    return tuple(t.contiguous() for t in (jac, g0, d1m, d2m, vc))


def _lib_fn(base, dtype):
    lib = _build.library()
    return getattr(lib, f"{base}_{'f32' if dtype == torch.float32 else 'f64'}")


def fused_obs_all_cuda(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int, dl: int,
                       e_start: int):
    """Launch kernel B1 on CUDA tensors (same contract as the reference)."""
    global LAUNCHES
    jac, g0, d1m, d2m, vc = _checked_inputs(
        "fused_obs_all", jac, g0, d1m, d2m, vc, dr_s, dl
    )
    n, s, k, L = jac.shape
    npairs = dr_s * (dr_s + 1) // 2
    dt, dev = jac.dtype, jac.device
    h_ll = torch.empty(dl, dl, L, dtype=dt, device=dev)
    g_l = torch.empty(dl, L, dtype=dt, device=dev)
    w = torch.zeros(L, dl, n_r * dr_s, dtype=dt, device=dev)
    ab = torch.zeros(npairs + dr_s, n_r, dtype=dt, device=dev)
    code = _lib_fn("fused_obs_all", dt)(
        jac.data_ptr(), g0.data_ptr(), d1m.data_ptr(), d2m.data_ptr(),
        vc.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(), w.data_ptr(),
        ab.data_ptr(), n, s, k, L, n_r, dr_s, dl, e_start,
        _build.stream_ptr(dev),
    )
    _build.check(code, "fused_obs_all launch")
    LAUNCHES += 1
    return h_ll, g_l, w, ab


def fused_obs_all_into_cuda(jac, g0, d1m, d2m, vc, h_ll, g_l, w, ab,
                            l_base: int, n_r: int, dr_s: int, dl: int,
                            e_start: int):
    """Launch kernel B2 on CUDA tensors (same contract as the reference).
    The buffers are updated in place, so they must be contiguous."""
    global INTO_LAUNCHES
    jac, g0, d1m, d2m, vc = _checked_inputs(
        "fused_obs_all_into", jac, g0, d1m, d2m, vc, dr_s, dl
    )
    n, s, k, L = jac.shape
    lt = w.shape[0]
    npairs = dr_s * (dr_s + 1) // 2
    for tname, t, shape in (
        ("h_ll", h_ll, (dl, dl, lt)), ("g_l", g_l, (dl, lt)),
        ("w", w, (lt, dl, n_r * dr_s)), ("ab", ab, (npairs + dr_s, n_r)),
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
        vc.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(), w.data_ptr(),
        ab.data_ptr(), n, s, k, L, lt, l_base, n_r, dr_s, dl, e_start,
        _build.stream_ptr(jac.device),
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


def fused_obs_all(jac, g0, d1m, d2m, vc, n_r: int, dr_s: int, dl: int,
                  e_start: int):
    """Kernel B1 on CUDA tensors, its plain version on CPU tensors."""
    if jac.is_cuda:
        return fused_obs_all_cuda(jac, g0, d1m, d2m, vc, n_r, dr_s, dl, e_start)
    if jac.device.type != "cpu":
        raise ValueError(f"fused_obs_all: unsupported device {jac.device}")
    return fused_obs_all_reference(jac, g0, d1m, d2m, vc, n_r, dr_s, dl, e_start)


def fused_obs_all_into(jac, g0, d1m, d2m, vc, h_ll, g_l, w, ab, l_base: int,
                       n_r: int, dr_s: int, dl: int, e_start: int):
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors."""
    args = (jac, g0, d1m, d2m, vc, h_ll, g_l, w, ab, l_base, n_r, dr_s, dl,
            e_start)
    if jac.is_cuda:
        return fused_obs_all_into_cuda(*args)
    if jac.device.type != "cpu":
        raise ValueError(f"fused_obs_all_into: unsupported device {jac.device}")
    return fused_obs_all_into_reference(*args)
