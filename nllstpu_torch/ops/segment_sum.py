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
(``csrc/segment_sum.cu``: a chunk-parallel segmented sum in two passes,
every addition in a fixed order, so the sums are the same from run to
run); on a CPU tensor it runs :func:`segment_block_sum_reference`.
:func:`segment_block_sum_chunked` is the plain mirror of the kernel's
chunk order, for the tests.
"""

from __future__ import annotations

import bisect

import torch

from . import _build

#: Number of wrapper calls that launched kernel B6 (its two passes count
#: once) in :func:`segment_block_sum_cuda`.
LAUNCHES = 0
#: Values per chunk of the kernel's first pass (16 KB of shared memory in
#: float32): a chunk is ``rows_per_chunk(D)`` whole rows.
CHUNK_ELEMS = 4096


def rows_per_chunk(d: int) -> int:
    """Rows in one chunk of kernel B6 at width ``d``."""
    return max(1, CHUNK_ELEMS // max(d, 1))


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


def segment_block_sum_chunked(data, starts, rows: int = None):
    """Plain mirror of kernel B6's two passes (same contract), for the
    tests: the runs' rows cut into chunks of ``rows`` (default
    :func:`rows_per_chunk`) from the first run's start; per chunk, each
    run's rows summed in row order, written out when the run lies whole in
    the chunk, else kept as the chunk's first partial (the run holding its
    first row, started before it or running past its end) or last partial
    (the run that starts inside and runs past its end); then every
    crossing run adds its partials in chunk order and every empty run is
    zero.  Host loops: small inputs only."""
    n, d = data.shape
    L = starts.shape[0] - 1
    R = rows_per_chunk(d) if rows is None else rows
    st = starts.long().clamp(0, n).tolist()
    out = data.new_full((L, d), float("nan"))
    if L == 0:
        return out
    base, end = st[0], max(st[L], st[0])
    nch = -(-n // R)
    first, last = {}, {}
    for c in range(nch):
        r0 = base + c * R
        if r0 >= end:
            break
        r1 = min(r0 + R, end)
        a = bisect.bisect_right(st, r0, 1, L + 1) - 1
        b = min(bisect.bisect_left(st, r1, 0, L + 1), L)
        for l in range(a, b):
            s, e = st[l], max(st[l + 1], st[l])
            if e <= s:
                continue
            lo, hi = max(s, r0), min(e, r1)
            acc = data[lo:hi].cumsum(0)[-1]  # row order, as the kernel adds
            if s >= r0 and e <= r1:
                out[l] = acc
            elif s <= r0:
                first[c] = acc
            else:
                last[c] = acc
    for l in range(L):
        s, e = st[l], max(st[l + 1], st[l])
        if e <= s:
            out[l] = 0
            continue
        c0, c1 = (s - base) // R, (e - 1 - base) // R
        if c0 == c1:
            continue
        acc = first[c0] if s == base + c0 * R else last[c0]
        for c in range(c0 + 1, c1 + 1):
            acc = acc + first[c]
        out[l] = acc
    return out


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
    if L * d >= 2**31 - 256:
        raise ValueError(f"segment_block_sum: {L} x {d} outputs pass the kernel's 32-bit index")
    out = torch.empty(L, d, dtype=data.dtype, device=data.device)
    if L == 0 or d == 0:
        return out
    rows = rows_per_chunk(d)
    # Two partial rows per chunk; only those of chunks a run crosses are
    # written and read.
    part = torch.empty(2 * max(-(-n // rows), 1), d, dtype=data.dtype, device=data.device)
    f = "f32" if data.dtype == torch.float32 else "f64"
    i = "i32" if starts.dtype == torch.int32 else "i64"
    code = getattr(_build.library(), f"segment_block_sum_{f}_{i}")(
        data.data_ptr(), starts.data_ptr(), out.data_ptr(), part.data_ptr(),
        n, L, d, rows, _build.stream_ptr(data.device),
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
