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

``reduce_s_lm(w [L, dl, wc], h_inv [dl, dl, L], g_l [dl, L])`` (kernel
B4) and ``reduce_s(w, h_inv, g_l, pairs)`` (kernel B5) are the same
reduction over inverses formed outside, for any dl from 1 to 6, and
return ``(s_sum, rhs_sum)``.  B4 takes the W of the obs-major assemblies
(B1, B2, B8), dense; B5 the generic assembly's W, whose column-block
structure ``pairs`` (:func:`pair_tables`, built at compile time)
describes: B5 reads W only inside those blocks and writes zeros elsewhere
in s_sum.  The solve takes B4 wherever B3 does not apply: every float64
solve, after the inverses are formed in float64.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/schur_reduce.cu``): B3 and B4 one dense body, a tiled FMA
contraction computing the upper triangle of s_sum (two-level sums within
a block) with split-K partials summed in a fixed order; B5 one warp per
item of the pair tables, each item's partial block then summed per pair in
item order.  rhs is summed in double.  On a CPU tensor each runs its plain
version, the dense ``reduce_s_reference`` for B4 and B5 alike.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.linearsolver import batched_inv_spd_cm
from . import _build

#: Edge of the s_sum tile one CUDA block owns (``kBM`` in the source).
TILE = 64

#: Number of kernel launches made by :func:`reduce_s_damped_cuda` (B3).
LAUNCHES = 0
#: Number of kernel launches made by :func:`reduce_s_cuda` (B5).
EXTERNAL_LAUNCHES = 0
#: Number of kernel launches made by :func:`reduce_s_lm_cuda` (B4).
LM_LAUNCHES = 0
#: Widest landmark block B4 and B5 take.
MAX_DL = 6
#: Widest column block of B5's tables (``kMaxWidth`` in the source).
MAX_WIDTH = 16
#: Landmarks per item of B5's pair tables.
PAIR_CHUNK = 64


class PairTables(NamedTuple):
    """Kernel B5's structure of W: its column blocks and, for every block
    pair i ≤ j that some landmark holds both of, those landmarks (int32
    arrays, host or device)."""

    bcol: Any  # [nb] first W column of each block
    bwidth: Any  # [nb] its width
    pairs: Any  # [P, 2] (i, j), i ≤ j, ascending
    pstarts: Any  # [P + 1] each pair's run of ``lmk``
    lmk: Any  # [nnz] landmarks holding both blocks, ascending within a pair
    items: Any  # [n_items, 3] (pair, first, end) in ``lmk``, ≤ PAIR_CHUNK landmarks
    istarts: Any  # [P + 1] each pair's run of ``items``
    max_width: int  # the widest block
    n_cols: int  # the end of the last block: W has at least this many columns


def pair_tables(lmk_of, blk_of, bcol, bwidth) -> PairTables:
    """Host :class:`PairTables` from the (landmark, block) incidences
    ``lmk_of``, ``blk_of`` (repeats ignored) over blocks at columns ``bcol``
    of widths ``bwidth`` (disjoint)."""
    bcol, bwidth = np.asarray(bcol, dtype=np.int64), np.asarray(bwidth, dtype=np.int64)
    nb = bcol.shape[0]
    if nb and (bwidth.min() < 1 or bwidth.max() > MAX_WIDTH):
        raise ValueError(f"pair_tables: block widths {bwidth.min()}..{bwidth.max()}"
                         f" outside 1..{MAX_WIDTH}")
    by_col = np.argsort(bcol)
    if np.any(bcol[by_col][1:] < (bcol + bwidth)[by_col][:-1]):
        raise ValueError("pair_tables: column blocks overlap")
    inc = np.unique(np.asarray(lmk_of, dtype=np.int64) * nb + np.asarray(blk_of, dtype=np.int64))
    l_inc, b_inc = inc // max(nb, 1), inc % max(nb, 1)
    # Every incidence p pairs with the incidences q ≥ p of its landmark.
    n_after = np.searchsorted(l_inc, l_inc, side="right") - np.arange(inc.shape[0])
    p_idx = np.repeat(np.arange(inc.shape[0]), n_after)
    q_idx = p_idx + np.arange(p_idx.shape[0]) - np.repeat(np.cumsum(n_after) - n_after, n_after)
    key = b_inc[p_idx] * nb + b_inc[q_idx]
    order = np.argsort(key, kind="stable")  # landmark order within a pair
    upairs, counts = np.unique(key[order], return_counts=True)
    pstarts = np.concatenate([[0], np.cumsum(counts)])
    n_chunks = -(-counts // PAIR_CHUNK)
    item_pair = np.repeat(np.arange(upairs.shape[0]), n_chunks)
    chunk = np.arange(item_pair.shape[0]) - np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks)
    i0 = pstarts[item_pair] + chunk * PAIR_CHUNK
    i32 = np.int32
    return PairTables(
        bcol=bcol.astype(i32),
        bwidth=bwidth.astype(i32),
        pairs=np.stack([upairs // max(nb, 1), upairs % max(nb, 1)], axis=1).astype(i32).reshape(-1, 2),
        pstarts=pstarts.astype(i32),
        lmk=l_inc[p_idx][order].astype(i32),
        items=np.stack([item_pair, i0, np.minimum(i0 + PAIR_CHUNK, pstarts[item_pair + 1])],
                       axis=1).astype(i32).reshape(-1, 3),
        istarts=np.concatenate([[0], np.cumsum(n_chunks)]).astype(i32),
        max_width=int(bwidth.max(initial=1)),
        n_cols=int((bcol + bwidth).max(initial=0)),
    )


def upload_pairs(tables: PairTables, device) -> PairTables:
    """The tables as contiguous int32 tensors on ``device``."""
    return tables._replace(**{
        name: torch.as_tensor(np.ascontiguousarray(getattr(tables, name)), device=device)
        for name in PairTables._fields[:-2]
    })


def reduce_s_reference(w, h_inv, g_l, pairs=None):
    """Plain PyTorch version of kernels B4 and B5 (same contract; the
    structure does not change the function).  The S product runs
    in the input dtype at full precision (float32 matmuls on the card
    default to full float32, not TF32)."""
    L, dl, wc = w.shape
    y = torch.einsum("edl,ldr->ler", h_inv, w)  # [L, dl, wc]
    s_sum = y.reshape(L * dl, wc).T @ w.reshape(L * dl, wc)
    return s_sum, torch.einsum("ler,el->r", y, g_l)


def reduce_s_pairs_reference(w, h_inv, g_l, pairs: PairTables):
    """Plain mirror of kernel B5's structure: the blocks Σ_l Y_l[:, i]ᵀ
    W_l[:, j] over each pair's landmarks (Y_l = H_l⁻¹ W_l), added per
    item and then per pair, written at (i, j) and mirrored; rhs from the
    diagonal pairs; zeros elsewhere.  Equals :func:`reduce_s_reference`
    when W is zero outside the blocks that ``pairs`` gives each
    landmark."""
    L, dl, wc = w.shape
    dev = w.device
    t = {k: torch.as_tensor(np.asarray(getattr(pairs, k)), device=dev).long()
         for k in ("bcol", "bwidth", "pairs", "pstarts", "lmk", "items")}
    mw = pairs.max_width
    s_sum = torch.zeros(wc, wc, dtype=w.dtype, device=dev)
    rhs = torch.zeros(wc, dtype=w.dtype, device=dev)
    n_pairs = t["pairs"].shape[0]
    if n_pairs == 0:
        return s_sum, rhs
    pair_of = torch.repeat_interleave(torch.arange(n_pairs, device=dev),
                                      t["pstarts"][1:] - t["pstarts"][:-1])
    bi, bj = t["pairs"][pair_of, 0], t["pairs"][pair_of, 1]
    ar = torch.arange(mw, device=dev)

    def cols(b):
        ok = ar[None] < t["bwidth"][b][:, None]
        return torch.where(ok, t["bcol"][b][:, None] + ar[None], 0), ok

    ci, oki = cols(bi)
    cj, okj = cols(bj)
    lm = t["lmk"]
    wl = w[lm]  # [nnz, dl, wc]
    wi = torch.where(oki[:, None], torch.gather(wl, 2, ci[:, None].expand(-1, dl, -1)), 0)
    wj = torch.where(okj[:, None], torch.gather(wl, 2, cj[:, None].expand(-1, dl, -1)), 0)
    y = torch.einsum("edn,ndr->ner", h_inv[:, :, lm], wi)  # [nnz, dl, mw]
    item_of = torch.repeat_interleave(torch.arange(t["items"].shape[0], device=dev),
                                      t["items"][:, 2] - t["items"][:, 1])
    part = torch.zeros(t["items"].shape[0], mw, mw, dtype=w.dtype, device=dev)
    part.index_add_(0, item_of, torch.einsum("ner,nes->nrs", y, wj))
    blocks = torch.zeros(n_pairs, mw, mw, dtype=w.dtype, device=dev)
    blocks.index_add_(0, t["items"][:, 0], part)
    pi, pj = t["pairs"][:, 0], t["pairs"][:, 1]
    (ri, oi), (rj, oj) = cols(pi), cols(pj)
    ok = oi[:, :, None] & oj[:, None, :]
    rr = ri[:, :, None].expand(-1, -1, mw)[ok]
    cc = rj[:, None, :].expand(-1, mw, -1)[ok]
    s_sum[rr, cc] = blocks[ok]
    off = (pi != pj)[:, None, None].expand(-1, mw, mw)[ok]
    s_sum[cc[off], rr[off]] = blocks[ok][off]
    diag = bi == bj
    r_ent = torch.einsum("ner,en->nr", y[diag], g_l[:, lm[diag]])  # [n_diag, mw]
    rows = ci[diag][oki[diag]]
    rhs.index_add_(0, rows, r_ent[oki[diag]])
    return s_sum, rhs


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


def reduce_s_lm_cuda(w, h_inv, g_l):
    """Launch kernel B4 on CUDA tensors (same contract as the reference)."""
    global LM_LAUNCHES
    w, h_inv, g_l = _checked("reduce_s_lm", w, h_inv, g_l, MAX_DL)
    L, dl, wc = w.shape
    splits, bufs = _partials(w)
    lib = _build.library()
    fn = lib.reduce_s_lm_f32 if w.dtype == torch.float32 else lib.reduce_s_lm_f64
    code = fn(
        w.data_ptr(), h_inv.data_ptr(), g_l.data_ptr(),
        *(b.data_ptr() for b in bufs), L, dl, wc, splits, _build.stream_ptr(w.device),
    )
    _build.check(code, "reduce_s_lm launch")
    LM_LAUNCHES += 1
    return bufs[2], bufs[3]


def reduce_s_cuda(w, h_inv, g_l, pairs: PairTables = None):
    """Launch kernel B5 over ``pairs`` (device :class:`PairTables` of W's
    structure) on CUDA tensors (same contract as the reference)."""
    global EXTERNAL_LAUNCHES
    w, h_inv, g_l = _checked("reduce_s", w, h_inv, g_l, MAX_DL)
    L, dl, wc = w.shape
    if pairs is None:
        raise ValueError("reduce_s: kernel B5 takes W's structure tables (pairs)")
    for name in PairTables._fields[:-2]:
        t = getattr(pairs, name)
        if not (torch.is_tensor(t) and t.dtype == torch.int32 and t.device == w.device
                and t.is_contiguous()):
            raise ValueError(f"reduce_s: pairs.{name} must be a contiguous int32 tensor on "
                             f"{w.device}")
    if not 1 <= pairs.max_width <= MAX_WIDTH:
        raise ValueError(f"reduce_s: block width {pairs.max_width} outside 1..{MAX_WIDTH}")
    if pairs.n_cols > wc:
        raise ValueError(f"reduce_s: the column blocks reach {pairs.n_cols}, W has {wc}")
    dt, dev = w.dtype, w.device
    mw, n_items, n_pairs = pairs.max_width, pairs.items.shape[0], pairs.pairs.shape[0]
    s_sum = torch.zeros(wc, wc, dtype=dt, device=dev)
    rhs = torch.zeros(wc, dtype=dt, device=dev)
    part = torch.empty(n_items, mw * mw, dtype=dt, device=dev)
    rpart = torch.empty(n_items, mw, dtype=torch.float64, device=dev)
    h_lm = h_inv.permute(2, 0, 1).contiguous()  # [L, dl, dl]: one landmark's inverse together
    g_lm = g_l.T.contiguous()
    f = "f32" if dt == torch.float32 else "f64"
    code = getattr(_build.library(), f"reduce_s_pairs_{f}")(
        w.data_ptr(), h_lm.data_ptr(), g_lm.data_ptr(), pairs.items.data_ptr(),
        pairs.pairs.data_ptr(), pairs.bcol.data_ptr(), pairs.bwidth.data_ptr(),
        pairs.lmk.data_ptr(), pairs.istarts.data_ptr(), part.data_ptr(),
        rpart.data_ptr(), s_sum.data_ptr(), rhs.data_ptr(), dl, wc, n_items,
        n_pairs, mw, _build.stream_ptr(dev),
    )
    _build.check(code, "reduce_s_pairs launch")
    EXTERNAL_LAUNCHES += 1
    return s_sum, rhs


def reduce_s_lm(w, h_inv, g_l):
    """Kernel B4 on CUDA tensors, the plain version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_lm_cuda(w, h_inv, g_l)
    if w.device.type != "cpu":
        raise ValueError(f"reduce_s_lm: unsupported device {w.device}")
    return reduce_s_reference(w, h_inv, g_l)


def reduce_s(w, h_inv, g_l, pairs: PairTables = None):
    """Kernel B5 over ``pairs`` on CUDA tensors (it raises without them);
    the plain version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_cuda(w, h_inv, g_l, pairs)
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
