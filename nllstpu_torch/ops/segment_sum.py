"""Kernel B6: ragged sorted-run row sums (port of
``nllstpu/ops/pallas/segment_sum.py:segment_block_sum``).

``segment_block_sum(data [N, D], starts [L+1]) -> out [L, D]`` with

    out[l] = data[starts[l] : starts[l+1]].sum(0)

``starts`` is non-decreasing, int32 or int64; rows outside
``[starts[0], starts[L])`` are ignored, and an empty run sums to zero.
This is every keyed reduction of the implicit Schur backend: the landmark
runs of the landmark-sorted costs, and the camera runs of the same costs
gathered into camera order.  The TPU kernel's chunk padding of ``data``
and its (8, 128) tile padding were DMA artefacts and are not carried
over.  On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/segment_sum.cu``: one warp per run, a fixed shuffle tree, so the
sums are the same from run to run); on a CPU tensor it runs
:func:`segment_block_sum_reference`.
"""

from __future__ import annotations

import torch

from . import _build

#: Number of kernel launches made by :func:`segment_block_sum_cuda`.
LAUNCHES = 0


def segment_block_sum_reference(data, starts):
    """Plain PyTorch version of kernel B6 (same contract), as the JAX
    package's reference computes it: each row's run id by a sorted search
    of ``starts`` (rows outside the runs go to a dropped extra run), then
    ``index_add_``.  No host sync."""
    L = starts.shape[0] - 1
    starts = starts.long()
    row = torch.arange(data.shape[0], device=data.device)
    seg = torch.searchsorted(starts[1:], row, right=True)
    seg = torch.where(row < starts[0], L, seg)
    out = data.new_zeros((L + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, seg, data)[:L]


def segment_block_sum_cuda(data, starts):
    """Launch kernel B6 on CUDA tensors (same contract as the reference)."""
    global LAUNCHES
    if data.dim() != 2:
        raise ValueError(f"segment_block_sum: data must be [N, D], got {tuple(data.shape)}")
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_block_sum: unsupported dtype {data.dtype}")
    if starts.dim() != 1 or starts.shape[0] < 1 or starts.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"segment_block_sum: starts must be int32/int64 [L+1], got "
            f"{starts.dtype} {tuple(starts.shape)}"
        )
    if starts.device != data.device:
        raise ValueError("segment_block_sum: data and starts on different devices")
    data, starts = data.contiguous(), starts.contiguous()
    (n, d), L = data.shape, starts.shape[0] - 1
    out = torch.empty(L, d, dtype=data.dtype, device=data.device)
    if L == 0 or d == 0:
        return out
    f = "f32" if data.dtype == torch.float32 else "f64"
    i = "i32" if starts.dtype == torch.int32 else "i64"
    code = getattr(_build.library(), f"segment_block_sum_{f}_{i}")(
        data.data_ptr(), starts.data_ptr(), out.data_ptr(), n, L, d,
        _build.stream_ptr(data.device),
    )
    _build.check(code, "segment_block_sum launch")
    LAUNCHES += 1
    return out


def segment_block_sum(data, starts):
    """Kernel B6 on CUDA tensors, its plain version on CPU tensors."""
    if data.is_cuda:
        return segment_block_sum_cuda(data, starts)
    if data.device.type != "cpu":
        raise ValueError(f"segment_block_sum: unsupported device {data.device}")
    return segment_block_sum_reference(data, starts)
