"""Kernels B3, B4 and B5: the Schur reductions of the direct solve (ports
of ``nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm_damped``,
``:reduce_s_lm`` and ``:reduce_s``).

``reduce_s_damped(w [L, dl, wc], h_ll [dl, dl, L], g_l [dl, L], lam,
rows)`` (kernel B3) forms the closed-form damped inverses H⁻¹ = (h_ll +
λI)⁻¹ per landmark, in float64, and returns

    s_sum [wc, wc] = Σ_l W_lᵀ H_l⁻¹ W_l
    rhs   [wc]     = Σ_l W_lᵀ H_l⁻¹ g_l
    h_inv [dl, dl, L]

The caller forms S = A_rr + λI − s_sum and rhs = b_r − rhs_sum.

``reduce_s_lm(w, h_inv, g_l, rows)`` (kernel B4) and ``reduce_s(w,
h_inv, g_l, pairs)`` (kernel B5) are the same reduction over inverses
formed outside, for any dl ≥ 1, and return ``(s_sum, rhs_sum)``.
B3 and B4 take the W of the obs-major assemblies (B1, B2, B8), whose
landmark rows hold their cameras' blocks only; B5 the generic assembly's
W, whose rows hold their cameras' blocks and the adaptive kernel's.  One
table type, :class:`RowTables` (:func:`row_tables`, built at compile
time), lists either W's column blocks, each landmark's blocks and, for
every block pair, the landmarks holding both.  The solve takes B5 for the
generic W, B3 for a float32 obs-major W with dl ≤ 3 and B4 for any other
obs-major W, after the inverses are formed in float64.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/schur_reduce.cu``, one structured body: Y = H⁻¹W once per
(landmark, block), then one warp per item of each block pair's
landmarks, then a fixed-order sum that writes every entry of s_sum and
its mirror once; rhs summed in double; B4 and B5 its external instance,
unrolled for dl ≤ 6 and, past it, tiled over dl with the item's blocks
staged through shared memory) and raises without its tables.  On a CPU
tensor each runs its plain version, the dense ``reduce_s_reference`` for
B4 and B5 alike.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.linearsolver import batched_inv_spd_cm
from . import _build

#: Number of kernel launches made by :func:`reduce_s_damped_cuda` (B3).
LAUNCHES = 0
#: Number of kernel launches made by :func:`reduce_s_cuda` (B5).
EXTERNAL_LAUNCHES = 0
#: Number of kernel launches made by :func:`reduce_s_lm_cuda` (B4).
LM_LAUNCHES = 0
#: Widest landmark block B3 takes (its closed-form inverses); B4 and B5
#: take any (dl ≤ 6 unrolled, wider through the tiled instance).
DAMPED_MAX_DL = 3
#: Widest landmark block of the unrolled instances (``kUnrolledDl`` in the
#: source); past it the tiled instance reads H⁻¹ landmark-major.
UNROLLED_DL = 6
#: Widest column block of the tables (``kMaxWidth`` in the source).
MAX_WIDTH = 16
#: Landmarks per item of the tables (``kLinkChunk`` in the source, which
#: stages an item's links in shared memory).
LINK_CHUNK = 64

#: The array fields of :class:`RowTables`, int32 on the host or the device.
_ARRAYS = ("lmk", "blk", "bcol", "bwidth", "pairs", "links", "items", "istarts")


class RowTables(NamedTuple):
    """Kernels B3's, B4's and B5's structure of W: its column blocks, each
    landmark's blocks (its incidences) and, for every block pair i ≤ j,
    the landmarks holding both, as pairs of incidences (int32 arrays, host
    or device: :func:`upload_tables`)."""

    lmk: Any  # [n_inc] landmark of each incidence, ascending; every landmark at least once
    blk: Any  # [n_inc] its block, ascending within a landmark; −1: the landmark holds none
    bcol: Any  # [n_blocks] first W column of each block, ascending
    bwidth: Any  # [n_blocks] its width, 1..MAX_WIDTH
    pairs: Any  # [n_blocks·(n_blocks+1)/2, 2] every block pair (i, j), i ≤ j, row-major
    links: Any  # [nnz, 2] (incidence at i, incidence at j) of each landmark holding both
    items: Any  # [n_items, 3] (pair, first, end) in ``links``, ≤ LINK_CHUNK landmarks
    istarts: Any  # [n_pairs + 1] each pair's run of ``items``
    max_width: int  # the widest block
    n_cols: int  # the end of the last block: W has at least this many columns
    covered: int  # the columns inside blocks: W's all when it equals wc
    device: Any = None  # the arrays' device, once :func:`upload_tables` checked them
    scratch: Any = None  # the launches' scratch on ``device``, by (dtype, dl)


def row_tables(lmk_of, blk_of, n_landmarks: int, bcol, bwidth) -> RowTables:
    """Host :class:`RowTables` from the (landmark, block) incidences
    ``lmk_of``, ``blk_of`` (repeats ignored) of ``n_landmarks`` landmarks
    over blocks at columns ``bcol`` (ascending) of widths ``bwidth``
    (disjoint).  A landmark without a block (its costs see fixed cameras
    only) keeps one incidence of block −1, so that B3 writes its inverse;
    a pair's links are in landmark order, cut into items; every block pair
    is listed, empty or not."""
    bcol, bwidth = np.asarray(bcol, dtype=np.int64), np.asarray(bwidth, dtype=np.int64)
    nb = bcol.shape[0]
    if nb and (bwidth.min() < 1 or bwidth.max() > MAX_WIDTH):
        raise ValueError(f"row_tables: block widths {bwidth.min()}..{bwidth.max()} outside "
                         f"1..{MAX_WIDTH}")
    if np.any(bcol[1:] < (bcol + bwidth)[:-1]):
        raise ValueError("row_tables: column blocks overlap or are not in column order")
    L = n_landmarks
    key = np.unique(np.asarray(lmk_of, dtype=np.int64) * (nb + 1)
                    + np.asarray(blk_of, dtype=np.int64) + 1)
    alone = np.setdiff1d(np.arange(L), key // (nb + 1))
    key = np.sort(np.concatenate([key, alone * (nb + 1)]))
    lmk, blk = key // (nb + 1), key % (nb + 1) - 1
    real = np.nonzero(blk >= 0)[0]
    p_idx, q_idx = _incidence_pairs(lmk[real])
    bi, bj = blk[real[p_idx]], blk[real[q_idx]]
    tri = bi * nb - bi * (bi - 1) // 2 + (bj - bi)  # row-major index among the i ≤ j pairs
    order = np.argsort(tri, kind="stable")  # landmark order within a pair
    n_pairs = nb * (nb + 1) // 2
    counts = np.bincount(tri, minlength=n_pairs)
    item_pair, i0, i1, istarts = _items(counts, LINK_CHUNK)
    pi, pj = np.triu_indices(nb)
    i32 = np.int32
    return RowTables(
        lmk=lmk.astype(i32),
        blk=blk.astype(i32),
        bcol=bcol.astype(i32),
        bwidth=bwidth.astype(i32),
        pairs=np.stack([pi, pj], axis=1).astype(i32).reshape(-1, 2),
        links=np.stack([real[p_idx], real[q_idx]], axis=1)[order].astype(i32).reshape(-1, 2),
        items=np.stack([item_pair, i0, i1], axis=1).astype(i32).reshape(-1, 3),
        istarts=istarts.astype(i32),
        max_width=int(bwidth.max(initial=1)),
        n_cols=int((bcol + bwidth).max(initial=0)),
        covered=int(bwidth.sum()),
    )


def uniform_blocks(n_blocks: int, width: int):
    """``(bcol, bwidth)`` of ``n_blocks`` adjacent blocks of ``width``
    columns from column 0, each cut into pieces of at most
    :data:`MAX_WIDTH` columns (block b's ⌈width / MAX_WIDTH⌉ pieces
    adjacent, in column order): an obs-major W's camera blocks."""
    n_pc = -(-width // MAX_WIDTH)
    k = np.arange(n_pc) * MAX_WIDTH
    bcol = (np.arange(n_blocks)[:, None] * width + k).reshape(-1)
    return bcol, np.tile(np.minimum(width - k, MAX_WIDTH), n_blocks)


def _incidence_pairs(l_inc):
    """Every incidence p of ``l_inc`` (landmarks, ascending) paired with
    the incidences q ≥ p of its landmark: ``(p_idx, q_idx)``, in landmark
    order."""
    n = l_inc.shape[0]
    n_after = np.searchsorted(l_inc, l_inc, side="right") - np.arange(n)
    p_idx = np.repeat(np.arange(n), n_after)
    q_idx = p_idx + np.arange(p_idx.shape[0]) - np.repeat(np.cumsum(n_after) - n_after, n_after)
    return p_idx, q_idx


def _items(counts, chunk):
    """Items of at most ``chunk`` entries over runs of ``counts``:
    ``(item_run, first, end, istarts)``, ``istarts`` each run's items."""
    starts = np.concatenate([[0], np.cumsum(counts)])
    n_chunks = -(-counts // chunk)
    item_run = np.repeat(np.arange(counts.shape[0]), n_chunks)
    k = np.arange(item_run.shape[0]) - np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks)
    i0 = starts[item_run] + k * chunk
    return item_run, i0, np.minimum(i0 + chunk, starts[item_run + 1]), np.concatenate(
        [[0], np.cumsum(n_chunks)])


def upload_tables(tables: RowTables, device) -> RowTables:
    """``tables`` with their arrays as contiguous int32 tensors on
    ``device``, checked once here (the wrappers check only ``device``),
    and an empty scratch cache."""
    device = torch.device(device)
    arrays = {name: torch.as_tensor(np.ascontiguousarray(getattr(tables, name)),
                                    dtype=torch.int32, device=device) for name in _ARRAYS}
    if not 1 <= tables.max_width <= MAX_WIDTH:
        raise ValueError(f"upload_tables: block width {tables.max_width} outside 1..{MAX_WIDTH}")
    n_pairs = arrays["bcol"].shape[0] * (arrays["bcol"].shape[0] + 1) // 2
    if (arrays["pairs"].shape != (n_pairs, 2) or arrays["istarts"].shape != (n_pairs + 1,)
            or arrays["lmk"].shape != arrays["blk"].shape):
        raise ValueError("upload_tables: the tables' arrays do not match one another")
    return tables._replace(**arrays, device=arrays["lmk"].device, scratch={})


def reduce_s_reference(w, h_inv, g_l, pairs=None):
    """Plain PyTorch version of kernels B4 and B5 (same contract; the
    structure does not change the function).  The S product runs
    in the input dtype at full precision (float32 matmuls on the card
    default to full float32, not TF32)."""
    L, dl, wc = w.shape
    y = torch.einsum("edl,ldr->ler", h_inv, w)  # [L, dl, wc]
    s_sum = y.reshape(L * dl, wc).T @ w.reshape(L * dl, wc)
    return s_sum, torch.einsum("ler,el->r", y, g_l)


def reduce_s_rows_reference(w, h_inv, g_l, rows: RowTables):
    """Plain mirror of the structured body of kernels B3, B4 and B5: Y =
    H⁻¹W once per incidence, then per link the block Y_l[:, i]ᵀ W_l[:, j],
    added per item in landmark order and per pair in item order, written at
    (i, j) and mirrored (a diagonal block from its upper triangle); rhs
    from the diagonal pairs; zeros outside the blocks.  Equals
    :func:`reduce_s_reference` when W is zero outside the blocks that
    ``rows`` gives each landmark."""
    L, dl, wc = w.shape
    dev, mw = w.device, rows.max_width
    t = {k: torch.as_tensor(np.asarray(getattr(rows, k)), device=dev).long() for k in _ARRAYS}
    ar = torch.arange(mw, device=dev)

    def cols(b):
        """Columns of blocks ``b`` [n, mw] (0 past a block's width) and
        their mask."""
        ok = ar < t["bwidth"][b][:, None]
        return torch.where(ok, t["bcol"][b][:, None] + ar, 0), ok

    lm, bk = t["lmk"], t["blk"]
    ci, oki = cols(bk.clamp_min(0))
    oki &= (bk >= 0)[:, None]
    # Each incidence's block W_l[:, b] [n_inc, dl, mw] (zero past its
    # width) and Y = H⁻¹ W.
    wb = torch.where(oki[:, None], torch.gather(w[lm], 2, ci[:, None].expand(-1, dl, -1)), 0)
    y = torch.einsum("edn,ndc->nec", h_inv[:, :, lm], wb)
    si, sj = t["links"][:, 0], t["links"][:, 1]
    items = t["items"]
    item_of = torch.repeat_interleave(torch.arange(items.shape[0], device=dev),
                                      items[:, 2] - items[:, 1])
    part = torch.zeros(items.shape[0], mw, mw, dtype=w.dtype, device=dev)
    part.index_add_(0, item_of, torch.einsum("nea,nec->nac", y[si], wb[sj]))
    n_pairs = t["pairs"].shape[0]
    blocks = torch.zeros(n_pairs, mw, mw, dtype=w.dtype, device=dev)
    blocks.index_add_(0, items[:, 0], part)
    pi, pj = t["pairs"][:, 0], t["pairs"][:, 1]
    blocks = torch.where((pi == pj)[:, None, None],
                         blocks.triu() + blocks.triu(1).transpose(1, 2), blocks)
    (ri, oi), (rj, oj) = cols(pi), cols(pj)
    ok = oi[:, :, None] & oj[:, None, :]
    rr = ri[:, :, None].expand(-1, -1, mw)[ok]
    cc = rj[:, None, :].expand(-1, mw, -1)[ok]
    s_sum = torch.zeros(wc, wc, dtype=w.dtype, device=dev)
    s_sum[rr, cc] = blocks[ok]
    s_sum[cc, rr] = blocks[ok]
    diag = si == sj
    r = torch.einsum("nea,en->na", y[si[diag]], g_l[:, lm[si[diag]]])
    rhs = torch.zeros(wc, dtype=w.dtype, device=dev)
    rhs.index_add_(0, ci[si[diag]][oki[si[diag]]], r[oki[si[diag]]])
    return s_sum, rhs


def reduce_s_damped_reference(w, h_ll, g_l, lam, rows=None):
    """Plain PyTorch version of kernel B3 (same contract; the tables do
    not change the function): the closed-form inverses of h_ll + λI in
    float64, cast to h_ll's dtype, then :func:`reduce_s_reference`.
    ``lam`` is a float or a 0-d tensor, with the same bits."""
    dl = w.shape[1]
    eye = torch.eye(dl, dtype=torch.float64, device=h_ll.device)
    h_inv = batched_inv_spd_cm(h_ll.double() + lam * eye[:, :, None]).to(h_ll.dtype)
    return (*reduce_s_reference(w, h_inv, g_l), h_inv)


def _checked(name, w, h, g_l, max_dl=None):
    """Contiguous ``(w, g_l)`` and ``h`` after the wrappers' common checks
    (``max_dl``: B3's widest landmark block); :func:`_launch_rows` lays
    ``h`` out for the instance."""
    L, dl, wc = w.shape
    if dl < 1 or (max_dl is not None and dl > max_dl):
        limit = f"1..{max_dl}" if max_dl is not None else "at least 1"
        raise ValueError(f"{name}: dl must be {limit}, got {dl}")
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
    return w.contiguous(), h, g_l.contiguous()


def lam_tensor(lam, device):
    """λ as the 0-d float64 tensor on ``device`` that kernel B3 reads: a
    0-d tensor as it is (cast to float64 if it is not), a float written by
    a fill on the device (no host-to-device copy).  Every float32 λ is
    exact in float64."""
    if torch.is_tensor(lam):
        return lam.to(device=device, dtype=torch.float64)
    return torch.full((), float(lam), dtype=torch.float64, device=device)


def _launch_rows(name, fn, w, h, g_l, lam, rows: RowTables, damped: bool):
    """Kernels B3 (``damped``, ``lam`` the 0-d float64 device tensor it
    reads), B4 and B5 (``lam`` None) on CUDA tensors: ``fn`` over the
    tables, checked by :func:`upload_tables`; returns ``(s_sum, rhs)``,
    and B3's ``h_inv``.  The outputs are views of one allocation; the
    scratch is allocated at the tables' first launch for this dtype and dl
    and reused after."""
    L, dl, wc = w.shape
    if rows is None:
        raise ValueError(f"{name}: kernels B3, B4 and B5 take W's block tables (rows)")
    if rows.device != w.device:
        raise ValueError(f"{name}: the tables are not on {w.device} (upload_tables)")
    if rows.n_cols > wc or rows.lmk.shape[0] < L:
        raise ValueError(f"{name}: the blocks reach column {rows.n_cols} and list "
                         f"{rows.lmk.shape[0]} incidences; W is {tuple(w.shape)}")
    dt, mw = w.dtype, rows.max_width
    n_inc, n_items, n_pairs = rows.lmk.shape[0], rows.items.shape[0], rows.pairs.shape[0]
    vec = 16 // w.element_size()
    bs = -(-dl * mw // vec) * vec  # one block, padded to 16 bytes
    scratch = rows.scratch.get((dt, dl))
    if scratch is None:
        scratch = rows.scratch[(dt, dl)] = (
            torch.empty(2 * n_inc * bs + n_items * mw * mw, dtype=dt, device=w.device),
            torch.empty(n_items, mw, dtype=torch.float64, device=w.device))
    yc, rpart = scratch
    out = torch.empty(wc * wc + wc + (dl * dl * L if damped else 0), dtype=dt, device=w.device)
    if rows.covered < wc:  # columns outside every block: zero there
        out[: wc * wc + wc].zero_()
    # The unrolled instances read H [dl, dl, L]; the tiled one [L, dl, dl]
    # (free for the solve's inverses, which are landmark-major underneath).
    h = h.contiguous() if dl <= UNROLLED_DL else h.permute(2, 0, 1).contiguous()
    elt, sp, op = w.element_size(), yc.data_ptr(), out.data_ptr()
    code = fn(
        w.data_ptr(), h.data_ptr(), g_l.data_ptr(), lam.data_ptr() if damped else None,
        rows.lmk.data_ptr(),
        rows.blk.data_ptr(), rows.bcol.data_ptr(), rows.bwidth.data_ptr(),
        rows.pairs.data_ptr(), rows.links.data_ptr(), rows.items.data_ptr(),
        rows.istarts.data_ptr(), sp, sp + n_inc * bs * elt, sp + 2 * n_inc * bs * elt,
        rpart.data_ptr(), op, op + wc * wc * elt, op + (wc * wc + wc) * elt if damped else 0,
        L, dl, wc, mw, bs, n_inc, n_items, n_pairs,
        int(rows.covered == rows.n_cols == rows.bcol.shape[0] * mw),  # adjacent blocks of mw
        _build.stream_ptr(w.device),
    )
    _build.check(code, f"{name} launch")
    outs = (out[: wc * wc].view(wc, wc), out[wc * wc : wc * wc + wc])
    return (*outs, out[wc * wc + wc :].view(dl, dl, L)) if damped else outs


def reduce_s_damped_cuda(w, h_ll, g_l, lam, rows: RowTables = None):
    """Launch kernel B3 over ``rows`` (device :class:`RowTables`) on
    float32 CUDA tensors (same contract as the reference).  The kernel
    reads λ from device memory (:func:`lam_tensor`), so a CUDA graph that
    captured the launch takes the λ written before each replay."""
    global LAUNCHES
    w, h_ll, g_l = _checked("reduce_s_damped", w, h_ll, g_l, DAMPED_MAX_DL)
    if w.dtype != torch.float32:
        raise TypeError("reduce_s_damped: kernel B3 takes float32; a float64 solve forms its "
                        "inverses with SchurOps.damped_inverse and takes B4 (reduce_s_lm)")
    out = _launch_rows("reduce_s_damped", _build.library().reduce_s_damped_f32, w, h_ll, g_l,
                       lam_tensor(lam, w.device), rows, damped=True)
    LAUNCHES += 1
    return out


def _external(w):
    """The external instance of the body for ``w``'s dtype (B4 and B5)."""
    f = "f32" if w.dtype == torch.float32 else "f64"
    return getattr(_build.library(), f"reduce_s_external_{f}")


def reduce_s_lm_cuda(w, h_inv, g_l, rows: RowTables = None):
    """Launch kernel B4 over ``rows`` (device :class:`RowTables` of an
    obs-major W) on CUDA tensors (same contract as the reference)."""
    global LM_LAUNCHES
    w, h_inv, g_l = _checked("reduce_s_lm", w, h_inv, g_l)
    out = _launch_rows("reduce_s_lm", _external(w), w, h_inv, g_l, None, rows, damped=False)
    LM_LAUNCHES += 1
    return out


def reduce_s_cuda(w, h_inv, g_l, pairs: RowTables = None):
    """Launch kernel B5 over ``pairs`` (device :class:`RowTables` of the
    generic W) on CUDA tensors (same contract as the reference)."""
    global EXTERNAL_LAUNCHES
    w, h_inv, g_l = _checked("reduce_s", w, h_inv, g_l)
    out = _launch_rows("reduce_s", _external(w), w, h_inv, g_l, None, pairs, damped=False)
    EXTERNAL_LAUNCHES += 1
    return out


def reduce_s_lm(w, h_inv, g_l, rows: RowTables = None):
    """Kernel B4 over ``rows`` on CUDA tensors (it raises without them);
    the plain version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_lm_cuda(w, h_inv, g_l, rows)
    if w.device.type != "cpu":
        raise ValueError(f"reduce_s_lm: unsupported device {w.device}")
    return reduce_s_reference(w, h_inv, g_l)


def reduce_s(w, h_inv, g_l, pairs: RowTables = None):
    """Kernel B5 over ``pairs`` on CUDA tensors (it raises without them);
    the plain version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_cuda(w, h_inv, g_l, pairs)
    if w.device.type != "cpu":
        raise ValueError(f"reduce_s: unsupported device {w.device}")
    return reduce_s_reference(w, h_inv, g_l)


def reduce_s_damped(w, h_ll, g_l, lam, rows: RowTables = None):
    """Kernel B3 over ``rows`` on float32 CUDA tensors (it raises without
    them, and on float64); its plain version on CPU tensors."""
    if w.is_cuda:
        return reduce_s_damped_cuda(w, h_ll, g_l, lam, rows)
    if w.device.type != "cpu":
        raise ValueError(f"reduce_s_damped: unsupported device {w.device}")
    return reduce_s_damped_reference(w, h_ll, g_l, lam)
