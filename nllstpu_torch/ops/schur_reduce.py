"""Kernels B3, B4 and B5: the Schur reductions of the direct solve (ports
of ``nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm_damped``,
``:reduce_s_lm`` and ``:reduce_s``).

``reduce_s_damped(w [L, dl, wc], h_ll [dl, dl, L], g_l [dl, L], lam)``
forms the closed-form damped inverses H⁻¹ = (h_ll + λI)⁻¹ per landmark and
returns

    s_sum [wc, wc] = Σ_l W_lᵀ H_l⁻¹ W_l
    rhs   [wc]     = Σ_l W_lᵀ H_l⁻¹ g_l
    h_inv [dl, dl, L]

Y = H⁻¹W is never stored.  The caller forms S = A_rr + λI − s_sum and
rhs = b_r − rhs_sum.

``reduce_s(w [L, dl, wc], h_inv [dl, dl, L], g_l [dl, L], obs_major=False)``
is the same reduction over inverses formed outside, for any dl from 1 to
6, and returns ``(s_sum, rhs_sum)``: kernel B5 on the generic assembly's
W, kernel B4 (``obs_major=True``) on the W of the obs-major assemblies
(B1, B2, B8).  The JAX package keeps that W p-major for the TPU and gives
it a kernel of its own; here both W are the same landmark-major layout,
so one entry point serves both and the route only picks the launch count
(``EXTERNAL_LAUNCHES`` or ``LM_LAUNCHES``).  The solve takes B4 wherever
B3 does not apply: every float64 solve, after the inverses are formed in
float64.

On a CUDA tensor each wrapper launches the hand-written kernel
(``csrc/schur_reduce.cu``, one kernel body in two modes): a tiled FMA
contraction computing the upper triangle of s_sum (two-level sums within
a block) with split-K partials summed in a fixed order, and rhs summed in
double; on a CPU tensor it runs its plain version.
"""

from __future__ import annotations

import torch

from ..core.linearsolver import batched_inv_spd_cm
from . import _build

#: Edge of the s_sum tile one CUDA block owns (``kBM`` in the source).
TILE = 64

#: Number of kernel launches made by :func:`reduce_s_damped_cuda` (B3).
LAUNCHES = 0
#: Number of kernel launches made by :func:`reduce_s_cuda` on the generic
#: W (B5).
EXTERNAL_LAUNCHES = 0
#: Number of kernel launches made by :func:`reduce_s_cuda` on an obs-major
#: W (B4).
LM_LAUNCHES = 0
#: Widest landmark block B5 takes.
MAX_DL = 6


def reduce_s_reference(w, h_inv, g_l, obs_major=False):
    """Plain PyTorch version of kernels B4 and B5 (same contract; the route
    does not change the function).  The S product runs in the input dtype
    at full precision (float32 matmuls on the card default to full
    float32, not TF32)."""
    L, dl, wc = w.shape
    y = torch.einsum("edl,ldr->ler", h_inv, w)  # [L, dl, wc]
    s_sum = y.reshape(L * dl, wc).T @ w.reshape(L * dl, wc)
    return s_sum, torch.einsum("ler,el->r", y, g_l)


def reduce_s_damped_reference(w, h_ll, g_l, lam):
    """Plain PyTorch version of kernel B3 (same contract)."""
    dl = w.shape[1]
    eye = torch.eye(dl, dtype=h_ll.dtype, device=h_ll.device)
    h_inv = batched_inv_spd_cm(h_ll + lam * eye[:, :, None])
    return (*reduce_s_reference(w, h_inv, g_l), h_inv)


def _splits(device, n_tiles: int, n_landmarks: int) -> int:
    """Split-K factor: about four resident blocks per SM over the upper
    triangle's tiles, each split keeping at least 64 landmarks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-4 * sms // n_tiles)
    return max(1, min(want, n_landmarks // 64))


def _checked(name, w, h, g_l, max_dl):
    """Contiguous ``(w, h, g_l)`` after the wrappers' common checks."""
    L, dl, wc = w.shape
    if not 1 <= dl <= max_dl:
        raise ValueError(f"{name}: dl must be 1..{max_dl}, got {dl}")
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {w.dtype}")
    if tuple(h.shape) != (dl, dl, L) or tuple(g_l.shape) != (dl, L):
        raise ValueError(
            f"{name}: {tuple(h.shape)}, g_l {tuple(g_l.shape)} do not match "
            f"w {tuple(w.shape)}"
        )
    for t in (h, g_l):
        if t.dtype != w.dtype or t.device != w.device:
            raise ValueError(f"{name}: inputs differ in dtype or device")
    return w.contiguous(), h.contiguous(), g_l.contiguous()


def _partials(w):
    """Split-K factor and the partial and output buffers of a launch."""
    L, _, wc = w.shape
    dt, dev = w.dtype, w.device
    nt = -(-wc // TILE)
    splits = _splits(dev, nt * (nt + 1) // 2, L)
    return splits, (
        torch.empty(splits, wc, wc, dtype=dt, device=dev),
        torch.empty(splits, wc, dtype=dt, device=dev),
        torch.empty(wc, wc, dtype=dt, device=dev),
        torch.empty(wc, dtype=dt, device=dev),
    )


def reduce_s_damped_cuda(w, h_ll, g_l, lam):
    """Launch kernel B3 on CUDA tensors (same contract as the reference)."""
    global LAUNCHES
    w, h_ll, g_l = _checked("reduce_s_damped", w, h_ll, g_l, 3)
    L, dl, wc = w.shape
    splits, bufs = _partials(w)
    h_inv = torch.empty(dl, dl, L, dtype=w.dtype, device=w.device)
    lib = _build.library()
    fn = lib.reduce_s_damped_f32 if w.dtype == torch.float32 else lib.reduce_s_damped_f64
    code = fn(
        w.data_ptr(), h_ll.data_ptr(), g_l.data_ptr(), float(lam),
        *(b.data_ptr() for b in bufs), h_inv.data_ptr(), L, dl, wc, splits,
        _build.stream_ptr(w.device),
    )
    _build.check(code, "reduce_s_damped launch")
    LAUNCHES += 1
    return bufs[2], bufs[3], h_inv


def reduce_s_cuda(w, h_inv, g_l, obs_major=False):
    """Launch kernel B5, or B4 with ``obs_major``, on CUDA tensors (same
    contract as the reference)."""
    global EXTERNAL_LAUNCHES, LM_LAUNCHES
    w, h_inv, g_l = _checked("reduce_s", w, h_inv, g_l, MAX_DL)
    L, dl, wc = w.shape
    splits, bufs = _partials(w)
    lib = _build.library()
    fn = lib.reduce_s_f32 if w.dtype == torch.float32 else lib.reduce_s_f64
    code = fn(
        w.data_ptr(), h_inv.data_ptr(), g_l.data_ptr(),
        *(b.data_ptr() for b in bufs), L, dl, wc, splits, _build.stream_ptr(w.device),
    )
    _build.check(code, "reduce_s launch")
    if obs_major:
        LM_LAUNCHES += 1
    else:
        EXTERNAL_LAUNCHES += 1
    return bufs[2], bufs[3]


def reduce_s(w, h_inv, g_l, obs_major=False):
    """Kernel B5, or B4 with ``obs_major``, on CUDA tensors; the plain
    version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_cuda(w, h_inv, g_l, obs_major)
    if w.device.type != "cpu":
        raise ValueError(f"reduce_s: unsupported device {w.device}")
    return reduce_s_reference(w, h_inv, g_l)


def reduce_s_damped(w, h_ll, g_l, lam):
    """Kernel B3 on CUDA tensors, its plain version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_damped_cuda(w, h_ll, g_l, lam)
    if w.device.type != "cpu":
        raise ValueError(f"reduce_s_damped: unsupported device {w.device}")
    return reduce_s_damped_reference(w, h_ll, g_l, lam)
