"""Schur-complement (landmark-eliminated) direct solve: host layout, the
system assembly through kernel B1, and the damped reduced solve through
kernel B3.  Port of the direct path of ``nllstpu/ops/schur.py``.

Block structure, with r = reduced (camera) and l = eliminated (landmark)
tangent dims:

    [A_rr  W ] [x_r]   [b_r]      S x_r = b_r − W H_ll⁻¹ g_l
    [Wᵀ  H_ll] [x_l] = [g_l]  →   S = A_rr − W H_ll⁻¹ Wᵀ
                                  x_l = H_ll⁻¹ (g_l − Wᵀ x_r)

``h_ll [dl, dl, L]`` and ``g_l [dl, L]`` keep the JAX package's
components-major layout; W is landmark-major ``[L, dl, Dr]`` in the
standard basis (camera ``v`` owns columns ``v·dr_s .. v·dr_s + dr_s − 1``).
The flat step vector is variable-major, as in the JAX package.

The host-side layout code (obs-major repack, bucket plan, degree counts)
is copied from the JAX package, which cannot be imported without jax.  A
uniform layout (one bucket) is assembled by kernel B1; a degree-bucketed
layout (skewed track lengths, as in real BAL data) by one launch of kernel
B2 per bucket, adding into buffers zeroed once per assembly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..core import engine
from ..core.linearsolver import cholesky_solve
from ..core.problem import family_name
from . import fused_obs, schur_reduce

#: Obs-major repack guards (as in the JAX package): largest uniform run
#: length, and the largest padded-columns-to-real-costs ratio.
_FAST_MAX_K = 512
_OBS_MAJOR_MAX_RATIO = 2.5
#: Per-bucket run-length cap of the bucketed layout.
_OBS_BUCKET_K_CAP = 64


def _group_rows(keys, n_keys):
    """Stable grouping of row indices by key (keys ≥ ``n_keys`` dropped):
    ``(rows_sorted, sorted_keys, counts, pos, k)`` with ``pos`` each row's
    rank in its run and ``k`` the longest run."""
    valid = np.nonzero(keys < n_keys)[0]
    counts = np.bincount(keys[valid], minlength=n_keys)
    k = int(max(counts.max(initial=0), 1))
    order = np.argsort(keys[valid], kind="stable")
    rows = valid[order]
    skey = keys[valid][order]
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(rows)) - np.repeat(starts, counts)
    return rows, skey, counts, pos, k


def _plan_obs_buckets(counts):
    """Bucket plan over DESCENDING per-landmark counts: power-of-two degree
    classes plus full-cap chunk buckets over the heavy prefix, as
    ``(l_base, L_b, k_b, obs_offset)``."""
    L = counts.shape[0]
    cap = _OBS_BUCKET_K_CAP

    def ceil8(x):
        return -(-int(x) // 8) * 8

    plan = []
    j = 1
    while True:
        h = int(np.sum(counts > j * cap))
        if h == 0:
            break
        width = min(cap, ceil8(int(counts[0]) - j * cap))
        plan.append((0, h, width, j * cap))
        j += 1
    base = np.minimum(counts, cap)
    cls = np.where(base > 0, 2 ** np.ceil(np.log2(np.maximum(base, 1))), 0)
    cls = cls.astype(np.int64)
    start = 0
    while start < L and cls[start] > 0:
        k_cls = int(cls[start])
        end = start + int(np.sum(cls[start:] == k_cls))
        k_b = min(k_cls, max(ceil8(int(counts[start])), 1))
        plan.append((start, end - start, k_b, 0))
        start = end
    return plan


def _elim_slots(batch, info):
    return [
        i for i, m in enumerate(batch.manifolds)
        if family_name(m) == info.elim_family
    ]


def _apply_take(batch, take, newmask):
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i)[take] for i in batch.idx),
        params=None if batch.params is None else np.asarray(batch.params)[take],
        mask=newmask,
    )


def obs_major_repack(batch, info: "SchurInfo"):
    """Reorder + pad a two-slot BA batch into landmark-run ("obs-major")
    column order: column ``col_base + (l − l_base)·K_b + j`` holds the j-th
    cost of landmark ``l`` (mask False beyond its count).  Uniform degree
    distributions get ONE bucket ``(0, L, K, 0)``; skewed ones get
    power-of-two degree-class buckets, which require degree-descending
    landmark ids.  Returns ``(repacked_batch, buckets)``, ``buckets`` a
    tuple of ``(l_base, L_b, k_b, col_base)`` (landmark ``l`` in ``[l_base,
    l_base + L_b)`` owns columns ``col_base + (l − l_base)·k_b + j``), or
    ``(None, None)`` when the batch does not qualify."""
    elim = _elim_slots(batch, info)
    if len(elim) != 1 or len(batch.manifolds) != 2 or info.num_elim == 0:
        return None, None
    e = elim[0]
    mask = np.asarray(batch.mask)
    L = info.num_elim
    lid = np.asarray(info.elim_ids[info.elim_family])[np.asarray(batch.idx[e])]
    lid = np.where(mask, lid, L)
    extra = np.nonzero(mask & (lid == L))[0]  # real costs, fixed landmark
    rows_sorted, skey, counts, pos, k = _group_rows(lid, L)
    uniform_total = L * k + len(extra)
    if k <= _FAST_MAX_K and uniform_total <= _OBS_MAJOR_MAX_RATIO * max(batch.n, 1):
        cols = skey * k + pos
        b_new = -(-uniform_total // 8) * 8
        take = np.zeros(b_new, dtype=np.int64)
        newmask = np.zeros(b_new, dtype=bool)
        take[cols] = rows_sorted
        newmask[cols] = True
        if len(extra):
            take[L * k : L * k + len(extra)] = extra
            newmask[L * k : L * k + len(extra)] = True
        return _apply_take(batch, take, newmask), ((0, L, k, 0),)
    if np.any(np.diff(counts) > 0):
        return None, None
    plan = _plan_obs_buckets(counts)
    total = sum(lb * kb for (_, lb, kb, _) in plan) + len(extra)
    if total > _OBS_MAJOR_MAX_RATIO * max(batch.n, 1):
        return None, None
    take = np.zeros(-(-total // 8) * 8, dtype=np.int64)
    newmask = np.zeros(take.shape[0], dtype=bool)
    col_base = 0
    buckets = []
    for (l0, lb, kb, ob) in plan:
        in_b = (skey >= l0) & (skey < l0 + lb) & (pos >= ob) & (pos < ob + kb)
        cols = col_base + (skey[in_b] - l0) * kb + (pos[in_b] - ob)
        take[cols] = rows_sorted[in_b]
        newmask[cols] = True
        buckets.append((l0, lb, kb, col_base))
        col_base += lb * kb
    if len(extra):
        take[col_base : col_base + len(extra)] = extra
        newmask[col_base : col_base + len(extra)] = True
    return _apply_take(batch, take, newmask), tuple(buckets)


def repack_batches_for_schur(batches, info: "SchurInfo"):
    """:func:`obs_major_repack` where it qualifies; ``(batches,
    buckets_per_batch)`` (``None`` for a batch left as it was)."""
    out, buckets = [], []
    for b in batches:
        nb, bk = obs_major_repack(b, info)
        out.append(nb if nb is not None else b)
        buckets.append(bk)
    return out, buckets


def elim_degree_counts(batches, problem, elim_manifold):
    """Per-variable observation counts of the eliminated family over all
    W-producing batches (the ``order_key`` of the degree relabel)."""
    elim_fam = family_name(elim_manifold)
    fam = problem._families.get(elim_fam)
    n = fam.n if fam is not None else 0
    counts = np.zeros(n, dtype=np.int64)
    for b in batches:
        eslots = [i for i, m in enumerate(b.manifolds) if family_name(m) == elim_fam]
        if len(eslots) != 1 or len(b.manifolds) < 2:
            continue
        idx = np.asarray(b.idx[eslots[0]])[np.asarray(b.mask)]
        counts += np.bincount(idx, minlength=n)
    return counts


@dataclasses.dataclass
class _FastBatch:
    """Host tables of an obs-major BA batch (one reduced slot, one
    eliminated slot)."""

    e_slot: int  # eliminated dependency slot
    n_r: int  # reduced family size
    rvid: np.ndarray  # [B] reduced var id (n_r = dustbin for masked costs)
    row_base: np.ndarray  # [n_r] global tangent offset per reduced var
    buckets: tuple  # ((l_base, L_b, k_b, col_base), ...)
    vc: tuple = ()  # per bucket: device int32 [k_b, L_b] camera id per slot
    pair_of: Any = None  # device [dr_s²]: ab row of a_rr entry (p, q)


def _fast_batch_data(batch, layout, info, buckets=None):
    """Fast-path tables of one repacked batch, or None when the batch is
    not an obs-major two-slot BA batch."""
    elim = _elim_slots(batch, info)
    if buckets is None or len(elim) != 1 or len(batch.manifolds) != 2:
        return None
    e = elim[0]
    r_slot = 1 - e
    rfam = family_name(batch.manifolds[r_slot])
    n_r = int(layout.unfixed[rfam].shape[0])
    off_r = np.asarray(layout.offsets[rfam])
    rvid = np.asarray(batch.idx[r_slot]).astype(np.int32).copy()
    rvid[~np.asarray(batch.mask)] = n_r
    return _FastBatch(
        e_slot=e,
        n_r=n_r,
        rvid=rvid,
        row_base=np.minimum(off_r, info.dim_reduced).astype(np.int32),
        buckets=buckets,
    )


@dataclasses.dataclass
class SchurInfo:
    """Static structure of the direct Schur system."""

    elim_family: str
    dim_reduced: int  # Dr
    num_elim: int  # L
    dof_elim: int  # dl
    elim_ids: dict  # family name -> [n] landmark ids
    fast: tuple = ()  # per-batch _FastBatch or None


def build_schur_info(problem, layout, elim_manifold, batches=None,
                     buckets=None) -> SchurInfo:
    """Reduced/eliminated split of a layout built with the eliminated family
    ordered last; with ``batches``, also the per-batch fast tables."""
    elim_fam = family_name(elim_manifold)
    dl = elim_manifold.dof
    offs = np.asarray(layout.offsets[elim_fam])
    num_elim = offs.shape[0]
    dim_reduced = layout.dof_total - num_elim * dl
    ids = ((offs - dim_reduced) // dl).astype(np.int32)
    info = SchurInfo(
        elim_family=elim_fam,
        dim_reduced=dim_reduced,
        num_elim=num_elim,
        dof_elim=dl,
        elim_ids={elim_fam: ids},
    )
    if batches is not None:
        per_batch = buckets if buckets is not None else [None] * len(batches)
        info.fast = tuple(
            _fast_batch_data(b, layout, info, buckets=bk)
            for b, bk in zip(batches, per_batch)
        )
    return info


def check_slice(info: SchurInfo, batches) -> None:
    """Raise ``NotImplementedError`` unless every batch takes the port's
    path: an obs-major BA batch (any number of degree buckets) whose
    cameras fill the reduced space in order."""
    for bi, b in enumerate(batches):
        f = info.fast[bi] if bi < len(info.fast) else None
        if f is None:
            raise NotImplementedError(
                f"cost batch {bi} is not a two-slot camera/landmark batch in "
                "obs-major order; other batch shapes take the generic Schur "
                "assembly of a later slice of the port"
            )
        dr_s = sum(m.dof for m in b.manifolds) - info.dof_elim
        if f.n_r * dr_s != info.dim_reduced or not np.array_equal(
            f.row_base, np.arange(f.n_r, dtype=np.int32) * dr_s
        ):
            raise NotImplementedError(
                "the reduced space must be exactly the batch's cameras in "
                "order (no other reduced families, no fixed cameras)"
            )


def upload_fast(info: SchurInfo, device) -> None:
    """Place each batch's per-bucket ``[k_b, L_b]`` camera-id tables and
    the a_rr pair index of the kernels' ``ab`` rows (upper triangle,
    row-major) on the device."""
    for f in info.fast:
        f.vc = tuple(
            torch.as_tensor(
                np.ascontiguousarray(f.rvid[c0 : c0 + lb * kb].reshape(lb, kb).T),
                device=device,
            )
            for (_, lb, kb, c0) in f.buckets
        )
        dr_s = info.dim_reduced // f.n_r
        pi, qi = np.triu_indices(dr_s)
        pair_of = np.zeros((dr_s, dr_s), dtype=np.int64)
        pair_of[pi, qi] = np.arange(len(pi))
        pair_of[qi, pi] = pair_of[pi, qi]
        f.pair_of = torch.as_tensor(pair_of.reshape(-1), device=device)


def fused_inputs(batch, variables, info: SchurInfo, fast: _FastBatch, dtype):
    """``(cost, args)``: the batch's masked cost and, per bucket, the
    arguments of kernels B1/B2 — the K-major run tiles ``jac [n, S, k_b,
    L_b]``, ``g0``, ``ρ′·mask``, ``2ρ″·mask`` and the camera ids, then
    ``(n_r, dr_s, dl, e_start)``."""
    e = fast.e_slot
    cost, _, jac, g0, d1, d2 = engine.batch_res_jac_cm(
        batch, variables, runs=(e, fast.buckets)
    )
    mval = batch.mask.to(dtype)
    d1m = d1 * mval
    d2m = 2.0 * d2 * mval
    dofs = [m.dof for m in batch.manifolds]
    nres, stot = jac.shape[0], jac.shape[1]
    args = []
    for (_, lb, kb, c0), vc in zip(fast.buckets, fast.vc):
        sl = slice(c0, c0 + lb * kb)
        args.append((
            jac[:, :, sl].reshape(nres, stot, lb, kb).transpose(2, 3),
            g0[:, sl].reshape(stot, lb, kb).transpose(1, 2),
            d1m[sl].reshape(lb, kb).T,
            d2m[sl].reshape(lb, kb).T,
            vc,
            fast.n_r,
            sum(dofs) - info.dof_elim,
            info.dof_elim,
            sum(dofs[:e]),
        ))
    return cost, args


def assemble_schur(batches, variables, info: SchurInfo, dtype,
                   assemble_kernel: Callable = fused_obs.fused_obs_all,
                   assemble_into_kernel: Callable = fused_obs.fused_obs_all_into):
    """``(cost, (a_rr, b_r, h_ll, g_l, w))`` through the whole-system
    assembly kernels, one pass per batch over its obs-major Jacobian: kernel
    B1 for a single-bucket batch, one launch of kernel B2 per bucket, in
    plan order, for a degree-bucketed one.  ``batches`` are the compiled
    device batches; :func:`check_slice` has vetted them."""
    dr, L, dl = info.dim_reduced, info.num_elim, info.dof_elim
    dev = next(iter(variables.values())).device
    total = torch.zeros((), dtype=dtype, device=dev)
    a_rr = torch.zeros(dr, dr, dtype=dtype, device=dev)
    b_r = torch.zeros(dr, dtype=dtype, device=dev)
    h_ll = torch.zeros(dl, dl, L, dtype=dtype, device=dev)
    g_l = torch.zeros(dl, L, dtype=dtype, device=dev)
    w = None
    for batch, fast in zip(batches, info.fast):
        cost, args = fused_inputs(batch, variables, info, fast, dtype)
        total = total + cost
        n_r, dr_s = fast.n_r, args[0][6]
        if len(args) == 1:
            h_add, g_add, w_b, ab = assemble_kernel(*args[0])
            h_ll = h_ll + h_add
            g_l = g_l + g_add
            w = w_b if w is None else w + w_b
        else:
            # B2 adds into h_ll, g_l, W and ab in place; W is zeroed once.
            if w is None:
                w = torch.zeros(L, dl, n_r * dr_s, dtype=dtype, device=dev)
            ab = torch.zeros(dr_s * (dr_s + 3) // 2, n_r, dtype=dtype, device=dev)
            for (l0, _, _, _), a in zip(fast.buckets, args):
                assemble_into_kernel(*a[:5], h_ll, g_l, w, ab, l0, *a[5:])
        # ab rows: the upper-triangle a_rr pairs, then b_r; camera v's block
        # lands on the diagonal at v·dr_s (check_slice).
        npairs = dr_s * (dr_s + 1) // 2
        a_blocks = ab[fast.pair_of].reshape(dr_s, dr_s, n_r).permute(2, 0, 1)
        a4 = a_rr.view(n_r, dr_s, n_r, dr_s)
        ar = torch.arange(n_r, device=dev)
        a4[ar, :, ar, :] += a_blocks
        b_r = b_r + ab[npairs:].T.reshape(-1)
    return total, (a_rr, b_r, h_ll, g_l, w)


@dataclasses.dataclass(frozen=True)
class SchurOps:
    """Linear-system ops over ``sys = (a_rr, b_r, h_ll, g_l, w)``: the
    protocol the iterators use (``grad``, ``diag_max``, ``solve``)."""

    dim_reduced: int
    #: damped reduction: kernel B3's dispatcher, or its plain version.
    reduce: Callable = schur_reduce.reduce_s_damped

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return torch.cat([b_r, g_l.T.reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        m_r = torch.diagonal(a_rr).abs().max()
        m_l = torch.diagonal(h_ll, dim1=0, dim2=1).abs().max()
        return torch.maximum(m_r, m_l)

    def solve(self, sys, lam):
        """x with (H + λI) x = g, through the damped reduction."""
        a_rr, b_r, h_ll, g_l, w = sys
        L, dl, wc = w.shape
        s_sum, rhs_sum, h_inv = self.reduce(w, h_ll, g_l, lam)
        eye = torch.eye(self.dim_reduced, dtype=a_rr.dtype, device=a_rr.device)
        xr = cholesky_solve(a_rr + lam * eye - s_sum, b_r - rhs_sum)
        wx = (w.reshape(L * dl, wc) @ xr).reshape(L, dl).T  # [dl, L]
        xl = torch.einsum("del,el->dl", h_inv, g_l - wx)
        return torch.cat([xr, xl.T.reshape(-1)])
