"""Kernel B7: placement of the Schur coupling W (port of
``nllstpu/ops/pallas/w_place.py:place_w_pm``).

``place_w(we [B, dl, dr_s], lstarts [L+1], colbase [B], wc) -> w [L, dl,
wc]`` with

    w[l, d, colbase[b] + p] = Σ we[b, d, p]  over the costs b of landmark l

the costs sorted by landmark (landmark l owns rows ``lstarts[l] ..
lstarts[l+1] − 1``) and ``colbase[b]`` the first W column of cost b's
camera, −1 for a cost that is dropped (masked, or its camera at or past
n_r; any cost whose columns do not fit in W is dropped).  Two costs of
one (landmark, camera) pair add.  Every entry of W is written, zeros
included; columns no cost reaches (an adaptive kernel's) stay zero for
the caller.  The TPU kernel's p-major, landmark-minor W and
its one-hot over padded camera ids were Mosaic layout workarounds and are
not carried over: W is the port's standard landmark-major basis.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/w_place.cu``: a block builds the ``[dl, wc]`` rows of a few
landmarks in shared memory — a row past a block's 227 KB in column spans,
a block each — one thread per (landmark, entry) adding the landmark's
costs in run order, and writes them once with 16-byte stores;
deterministic, no atomics); on a CPU tensor it runs
:func:`place_w_reference`.
"""

from __future__ import annotations

import torch

from . import _build

#: Number of kernel launches made by :func:`place_w_cuda`.
LAUNCHES = 0


def flat_index(lstarts, colbase, dl: int, dr_s: int, wc: int):
    """``(keep [B·dl·dr_s], index [B·dl·dr_s])``: whether each entry of
    ``we`` lands, and its offset in the flattened ``w`` — each row's
    landmark by a sorted search of ``lstarts``, as kernel B6's plain
    version finds its runs."""
    L = lstarts.shape[0] - 1
    starts = lstarts.long()
    row = torch.arange(colbase.shape[0], device=colbase.device)
    lid = torch.searchsorted(starts[1:], row, right=True)
    keep = (row >= starts[0]) & (lid < L) & (colbase >= 0) & (colbase <= wc - dr_s)
    d = torch.arange(dl, device=row.device)[:, None]
    p = torch.arange(dr_s, device=row.device)[None, :]
    idx = (lid[:, None, None] * dl + d) * wc + colbase.long()[:, None, None] + p
    keep = keep[:, None, None].expand(-1, dl, dr_s)
    return keep.reshape(-1), torch.where(keep, idx, 0).reshape(-1)


def place_w_reference(we, lstarts, colbase, wc: int):
    """Plain PyTorch version of kernel B7 (same contract): the flat index
    of every entry, then ``index_add_`` into a zeroed W."""
    B, dl, dr_s = we.shape
    L = lstarts.shape[0] - 1
    keep, idx = flat_index(lstarts, colbase, dl, dr_s, wc)
    w = we.new_zeros(L * dl * wc)
    w.index_add_(0, idx, torch.where(keep, we.reshape(-1), 0))
    return w.view(L, dl, wc)


def place_w_cuda(we, lstarts, colbase, wc: int):
    """Launch kernel B7 on CUDA tensors (same contract as the reference)."""
    global LAUNCHES
    if we.dim() != 3:
        raise ValueError(f"place_w: we must be [B, dl, dr_s], got {tuple(we.shape)}")
    if we.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"place_w: unsupported dtype {we.dtype}")
    B, dl, dr_s = we.shape
    if lstarts.dtype != torch.int32 or colbase.dtype != torch.int32:
        raise TypeError("place_w: lstarts and colbase must be int32")
    if lstarts.dim() != 1 or lstarts.shape[0] < 1 or tuple(colbase.shape) != (B,):
        raise ValueError(
            f"place_w: lstarts {tuple(lstarts.shape)}, colbase "
            f"{tuple(colbase.shape)} do not match we {tuple(we.shape)}"
        )
    if lstarts.device != we.device or colbase.device != we.device:
        raise ValueError("place_w: inputs on different devices")
    if not 0 < dr_s <= wc:
        raise ValueError(f"place_w: dr_s {dr_s} outside W's {wc} columns")
    we, lstarts, colbase = we.contiguous(), lstarts.contiguous(), colbase.contiguous()
    L = lstarts.shape[0] - 1
    w = torch.empty(L, dl, wc, dtype=we.dtype, device=we.device)
    if L == 0:
        return w
    f = "f32" if we.dtype == torch.float32 else "f64"
    code = getattr(_build.library(), f"place_w_{f}")(
        we.data_ptr(), lstarts.data_ptr(), colbase.data_ptr(), w.data_ptr(),
        B, L, dl, dr_s, wc, _build.stream_ptr(we.device),
    )
    _build.check(code, "place_w launch")
    LAUNCHES += 1
    return w


def place_w(we, lstarts, colbase, wc: int):
    """Kernel B7 on CUDA tensors, its plain version on CPU tensors."""
    if we.is_cuda:
        return place_w_cuda(we, lstarts, colbase, wc)
    if we.device.type != "cpu":
        raise ValueError(f"place_w: unsupported device {we.device}")
    return place_w_reference(we, lstarts, colbase, wc)
