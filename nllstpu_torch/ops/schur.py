"""Schur-complement (landmark-eliminated) solves: host layout, the direct
path (assembly through kernels B1/B2, the damped reduced solve through
kernel B3) and the implicit path (every keyed reduction through kernel B6,
the reduced system solved by PCG without forming S).  Port of
``nllstpu/ops/schur.py``.

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

The implicit path (:class:`SchurCGOps`) never stores W.  Its batches are
sorted by landmark at compile time (the reference's
``reordercostsforschur!``), the layout kernel B6 was written for; the
same costs are also indexed in camera order.  Landmark-keyed sums (h_ll,
g_l, Wᵀv) are B6 over the landmark runs, camera-keyed sums (a_rr, b_r,
W u, the preconditioner's correction) B6 over the camera runs.  The JAX
package's obs-major repack of implicit batches existed only because
lane-axis gathers are slow on the TPU and is not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import engine
from ..core.linearsolver import batched_inv_spd, batched_inv_spd_cm, cholesky_solve
from ..core.problem import family_name
from . import fused_obs, schur_reduce
from .segment_sum import segment_block_sum

#: Reduced-PCG iterations between host reads of the convergence flag.
#: Updates freeze once converged, so the result equals a loop that checks
#: after every iteration; a solve pays at most this many idle iterations
#: and reads the device once per chunk instead of once per iteration.
CG_CHECK_EVERY = 8
#: Reduced-PCG iteration cap (the JAX package's ``SchurCGOps.max_iters``).
CG_MAX_ITERS = 500

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
    mask = np.asarray(batch.mask)
    L = info.num_elim
    lid = _landmark_ids(batch, info, elim[0])
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


class WPart(NamedTuple):
    """Per-batch coupling part of the implicit system: the per-cost
    coupling blocks in landmark-sorted order and the device tables that
    key them."""

    w_blk: Any  # [B, dr_s, dl] coupling block of each cost (zero when masked)
    rows_r: Any  # [B, dr_s] reduced row of each block row (Dr = dustbin)
    lid: Any  # [B] landmark id of each cost (L = dustbin)
    lstarts: Any  # int32 [L+1] landmark runs of the sorted costs
    cperm: Any  # [Nc] rows of the real costs, in camera order
    cstarts: Any  # int32 [n_r+1] camera runs of ``cperm``


@dataclasses.dataclass
class _RunBatch:
    """Host tables of a landmark-sorted BA batch (one reduced slot, one
    eliminated slot) for the implicit backend."""

    e_slot: int  # eliminated dependency slot
    n_r: int  # reduced family size
    row_base: np.ndarray  # [n_r] global tangent offset per reduced var
    lid: np.ndarray  # [B] landmark id per sorted cost (L for masked ones)
    rvid: np.ndarray  # [B] camera id per sorted cost (n_r for masked ones)
    lstarts: np.ndarray  # int32 [L+1]
    cperm: np.ndarray  # [Nc] sorted rows of the real costs, camera-stable order
    cstarts: np.ndarray  # int32 [n_r+1]
    keys: Any = None  # device WPart without w_blk (upload_implicit)
    pair_of: Any = None  # device [dr_s²]: ab row of a_rr entry (p, q)


@dataclasses.dataclass
class SchurInfo:
    """Static structure of the Schur system.  ``implicit`` selects the
    matrix-free solve (:class:`SchurCGOps`), whose per-batch tables in
    ``fast`` are :class:`_RunBatch`; otherwise the direct solve over a
    dense W (:class:`SchurOps`, tables :class:`_FastBatch`)."""

    elim_family: str
    dim_reduced: int  # Dr
    num_elim: int  # L
    dof_elim: int  # dl
    elim_ids: dict  # family name -> [n] landmark ids
    fast: tuple = ()  # per-batch _FastBatch / _RunBatch or None
    implicit: bool = False
    # Reduced families (name, offsets [n], dof), for the preconditioner.
    fam_offsets: tuple = ()


def build_schur_info(problem, layout, elim_manifold, batches=None,
                     buckets=None, implicit: bool = False) -> SchurInfo:
    """Reduced/eliminated split of a layout built with the eliminated family
    ordered last; with ``batches``, also the per-batch tables (for
    ``implicit``, of batches already sorted by :func:`sort_for_implicit`)."""
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
        implicit=implicit,
        fam_offsets=tuple(
            (name, np.asarray(layout.offsets[name]), problem.manifold_of(name).dof)
            for name in problem.family_names() if name != elim_fam
        ) if implicit else (),
    )
    if batches is not None:
        if implicit:
            info.fast = tuple(_run_batch_data(b, layout, info) for b in batches)
        else:
            per_batch = buckets if buckets is not None else [None] * len(batches)
            info.fast = tuple(
                _fast_batch_data(b, layout, info, buckets=bk)
                for b, bk in zip(batches, per_batch)
            )
    return info


def _landmark_ids(batch, info, e):
    """Landmark id per cost, ``L`` (the dustbin) for masked ones."""
    lid = np.asarray(info.elim_ids[info.elim_family])[np.asarray(batch.idx[e])]
    return np.where(np.asarray(batch.mask), lid, info.num_elim)


def sort_for_implicit(batch, info: SchurInfo):
    """The batch with its costs sorted by landmark id, masked costs last
    (the JAX package's ``_elim_sort_data``, the reference's
    ``reordercostsforschur!``); a batch that is not one camera slot plus
    one landmark slot is returned as it is."""
    elim = _elim_slots(batch, info)
    if len(elim) != 1 or len(batch.manifolds) != 2 or info.num_elim == 0:
        return batch
    perm = np.argsort(_landmark_ids(batch, info, elim[0]), kind="stable")
    return _apply_take(batch, perm, np.asarray(batch.mask)[perm])


def _run_batch_data(batch, layout, info):
    """Run tables of a landmark-sorted two-slot batch, or None."""
    elim = _elim_slots(batch, info)
    if len(elim) != 1 or len(batch.manifolds) != 2 or info.num_elim == 0:
        return None
    e = elim[0]
    L = info.num_elim
    lid = _landmark_ids(batch, info, e)
    if np.any(np.diff(lid) < 0):
        return None  # not sorted by sort_for_implicit
    rfam = family_name(batch.manifolds[1 - e])
    n_r = int(layout.unfixed[rfam].shape[0])
    rvid = np.asarray(batch.idx[1 - e]).astype(np.int64)
    rvid[~np.asarray(batch.mask)] = n_r
    real = np.nonzero(rvid < n_r)[0]
    cperm = real[np.argsort(rvid[real], kind="stable")]

    def runs(keys, n):
        counts = np.bincount(keys, minlength=n)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    return _RunBatch(
        e_slot=e,
        n_r=n_r,
        row_base=np.minimum(np.asarray(layout.offsets[rfam]), info.dim_reduced).astype(np.int32),
        lid=lid,
        rvid=rvid,
        lstarts=runs(lid[lid < L], L),
        cperm=cperm,
        cstarts=runs(rvid[real], n_r),
    )


def check_slice(info: SchurInfo, batches) -> None:
    """Raise ``NotImplementedError`` unless every batch takes the port's
    path: a BA batch — obs-major (any number of degree buckets) for the
    direct solve, landmark-sorted for the implicit one — whose cameras
    fill the reduced space in order."""
    order = "landmark-sorted" if info.implicit else "obs-major"
    for bi, b in enumerate(batches):
        f = info.fast[bi] if bi < len(info.fast) else None
        if f is None:
            raise NotImplementedError(
                f"cost batch {bi} is not a two-slot camera/landmark batch in "
                f"{order} order; other batch shapes take the generic Schur "
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
        f.pair_of = _pair_of(info.dim_reduced // f.n_r, device)


def _pair_of(dr_s: int, device):
    """[dr_s²] row of a_rr entry (p, q) among the upper-triangle rows
    (row-major) that the assembly reduces."""
    pi, qi = np.triu_indices(dr_s)
    pair_of = np.zeros((dr_s, dr_s), dtype=np.int64)
    pair_of[pi, qi] = np.arange(len(pi))
    pair_of[qi, pi] = pair_of[pi, qi]
    return torch.as_tensor(pair_of.reshape(-1), device=device)


def upload_implicit(info: SchurInfo, device) -> None:
    """Place each batch's run tables on the device (``_RunBatch.keys``)."""
    for f in info.fast:
        dr_s = info.dim_reduced // f.n_r
        rows = np.concatenate([f.row_base, [info.dim_reduced]])[f.rvid]
        rows = np.where(f.rvid[:, None] < f.n_r, rows[:, None] + np.arange(dr_s), info.dim_reduced)
        f.keys = WPart(
            w_blk=None,
            rows_r=torch.as_tensor(rows, dtype=torch.long, device=device),
            lid=torch.as_tensor(f.lid, dtype=torch.long, device=device),
            lstarts=torch.as_tensor(f.lstarts, device=device),
            cperm=torch.as_tensor(f.cperm, dtype=torch.long, device=device),
            cstarts=torch.as_tensor(f.cstarts, device=device),
        )
        f.pair_of = _pair_of(dr_s, device)


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
        b_r = _add_camera_blocks(a_rr, b_r, ab, fast.pair_of, n_r, dr_s)
    return total, (a_rr, b_r, h_ll, g_l, w)


def _add_camera_blocks(a_rr, b_r, ab, pair_of, n_r: int, dr_s: int):
    """Add the per-camera rows ``ab [npairs + dr_s, n_r]`` (the
    upper-triangle a_rr pairs, then b_r) into a_rr in place, camera v's
    block on the diagonal at v·dr_s (check_slice); returns b_r plus its
    part."""
    npairs = dr_s * (dr_s + 1) // 2
    a_blocks = ab[pair_of].reshape(dr_s, dr_s, n_r).permute(2, 0, 1)
    a4 = a_rr.view(n_r, dr_s, n_r, dr_s)
    ar = torch.arange(n_r, device=a_rr.device)
    a4[ar, :, ar, :] += a_blocks
    return b_r + ab[npairs:].T.reshape(-1)


def assemble_implicit(batches, variables, info: SchurInfo, dtype,
                      segment_sum: Callable = segment_block_sum):
    """``(cost, (a_rr, b_r, h_ll, g_l, wparts))`` for the implicit solve:
    the per-cost blocks of each landmark-sorted batch, composed per output
    from its raw residual data, and every keyed sum through ``segment_sum``
    (kernel B6's contract): h_ll and g_l (D = dl² + dl) over the landmark
    runs, the a_rr upper triangle and b_r (D = dr_s(dr_s+1)/2 + dr_s) over
    the camera runs.  The coupling blocks stay per cost in ``wparts``;
    no dense W is formed.  ``batches`` are the compiled device batches,
    vetted by :func:`check_slice`."""
    dr, L, dl = info.dim_reduced, info.num_elim, info.dof_elim
    dev = next(iter(variables.values())).device
    total = torch.zeros((), dtype=dtype, device=dev)
    a_rr = torch.zeros(dr, dr, dtype=dtype, device=dev)
    b_r = torch.zeros(dr, dtype=dtype, device=dev)
    h_ll = torch.zeros(dl, dl, L, dtype=dtype, device=dev)
    g_l = torch.zeros(dl, L, dtype=dtype, device=dev)
    wparts = []
    for batch, runs in zip(batches, info.fast):
        cost, _, jac, g0, d1, d2 = engine.batch_res_jac_cm(batch, variables)
        total = total + cost
        mval = batch.mask.to(dtype)
        d1m = d1 * mval
        d2m = 2.0 * d2 * mval
        dofs = [m.dof for m in batch.manifolds]
        e0 = sum(dofs[: runs.e_slot])
        r_rows = [i for i in range(sum(dofs)) if not e0 <= i < e0 + dl]
        dr_s = len(r_rows)
        je, jr = jac[:, e0 : e0 + dl], jac[:, r_rows]  # [n, dl | dr_s, B]
        ge, gr = g0[e0 : e0 + dl], g0[r_rows]
        n_b = jac.shape[-1]
        # Landmark side: the full dl×dl block and g_l per cost.
        he = torch.einsum("nab,ncb->acb", je, je) * d1m + d2m * ge[:, None] * ge[None]
        lrows = torch.cat([he.reshape(dl * dl, n_b), ge * d1m]).T.contiguous()
        lsum = segment_sum(lrows, runs.keys.lstarts)  # [L, dl² + dl]
        h_ll = h_ll + lsum[:, : dl * dl].T.reshape(dl, dl, L)
        g_l = g_l + lsum[:, dl * dl :].T
        # Camera side: the a_rr upper triangle and b_r, in camera order.
        pi, qi = np.triu_indices(dr_s)
        ha = (jr[:, pi] * jr[:, qi]).sum(0) * d1m + d2m * gr[pi] * gr[qi]
        crows = torch.cat([ha, gr * d1m]).T.index_select(0, runs.keys.cperm)
        ab = segment_sum(crows, runs.keys.cstarts)  # [n_r, npairs + dr_s]
        b_r = _add_camera_blocks(a_rr, b_r, ab.T, runs.pair_of, runs.n_r, dr_s)
        # Coupling blocks, batch-major: masked costs are exactly zero.
        w_blk = (
            torch.einsum("npb,ndb->bpd", jr, je) * d1m[:, None, None]
            + d2m[:, None, None] * gr.T[:, :, None] * ge.T[:, None, :]
        )
        wparts.append(runs.keys._replace(w_blk=w_blk))
    return total, (a_rr, b_r, h_ll, g_l, tuple(wparts))


class _SchurSystem:
    """``grad`` and ``diag_max`` over ``sys = (a_rr, b_r, h_ll, g_l, _)``,
    shared by both solves: with ``solve``, the protocol the iterators
    use."""

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return torch.cat([b_r, g_l.T.reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        m_r = torch.diagonal(a_rr).abs().max()
        m_l = torch.diagonal(h_ll, dim1=0, dim2=1).abs().max()
        return torch.maximum(m_r, m_l)


@dataclasses.dataclass(frozen=True)
class SchurOps(_SchurSystem):
    """The direct solve over ``sys = (a_rr, b_r, h_ll, g_l, w)``."""

    dim_reduced: int
    #: damped reduction: kernel B3's dispatcher, or its plain version.
    reduce: Callable = schur_reduce.reduce_s_damped

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


@dataclasses.dataclass(frozen=True)
class SchurCGOps(_SchurSystem):
    """Implicit (matrix-free) Schur: the reduced system S = A_rr + λI −
    W (H_ll + λI)⁻¹ Wᵀ is never formed.  Its matvec streams the per-cost
    coupling blocks of ``sys = (a_rr, b_r, h_ll, g_l, wparts)`` (gather →
    block product → B6 over landmark runs → H⁻¹ → block product → B6 over
    camera runs), and the reduced solve is PCG with the Schur-Jacobi
    preconditioner (the Ceres ``SCHUR_JACOBI`` analogue): S's exact
    per-camera diagonal blocks.  Port of the JAX package's ``SchurCGOps``
    without its TPU knobs (chunked or fixed-trip CG as worker-fault
    mitigations, cluster-Jacobi, the sharded hooks).

    ``segment_sum`` is kernel B6's dispatcher or its plain version.
    Every :meth:`solve` appends its PCG iteration count to ``cg_iters``."""

    dim_reduced: int
    num_elim: int
    dof_elim: int
    # Reduced families (name, offsets [n], dof); check_slice leaves one,
    # whose cameras fill the reduced space in order.
    fam_offsets: tuple
    # Relative PCG residual tolerance; None = 1e-5 in float32, 1e-12 in
    # float64 (a float64 tolerance is out of float32's reach and would
    # run every solve to CG_MAX_ITERS).
    tol: Optional[float] = None
    segment_sum: Callable = segment_block_sum
    cg_iters: list = dataclasses.field(default_factory=list, compare=False)

    def _tol(self, dtype):
        if self.tol is not None:
            return self.tol
        return 1e-5 if dtype == torch.float32 else 1e-12

    def _wt_apply(self, wparts, v):
        """u[:, l] = Σ_{costs c of l} w_cᵀ v[rows_c] → components-major
        [dl, L]: the block products per cost, then B6 over landmark runs."""
        vp = torch.cat([v, v.new_zeros(1)])  # row Dr is the dustbin
        u = None
        for wp in wparts:
            q = (wp.w_blk * vp[wp.rows_r][:, :, None]).sum(1)  # [B, dl]
            part = self.segment_sum(q, wp.lstarts)  # [L, dl]
            u = part if u is None else u + part
        return u.T

    def _w_apply(self, wparts, u):
        """y = Σ_c w_c u[:, l_c] at the cost's camera rows → [Dr], ``u``
        components-major [dl, L]: the block products per cost, gathered
        into camera order, then B6 over camera runs (deterministic, unlike
        a scatter-add)."""
        up = torch.cat([u.T, u.new_zeros(1, self.dof_elim)])  # row L: dustbin
        y = None
        for wp in wparts:
            t = (wp.w_blk * up[wp.lid][:, None, :]).sum(2)  # [B, dr_s]
            part = self.segment_sum(t.index_select(0, wp.cperm), wp.cstarts)
            y = part.reshape(-1) if y is None else y + part.reshape(-1)
        return y

    def s_matvec(self, sys, h_inv, lam, v):
        """S v with ``h_inv`` = (h_ll + λI)⁻¹ components-major."""
        a_rr, _, _, _, wparts = sys
        u = torch.einsum("del,el->dl", h_inv, self._wt_apply(wparts, v))
        return a_rr @ v + lam * v - self._w_apply(wparts, u)

    def precond_blocks(self, sys, lam, h_inv):
        """``(blocks, a_blocks)``, both ``[n_r, dof, dof]``: the damped
        Schur-Jacobi blocks (A_rr + λI)[v,v] − Σ_c w_c H⁻¹ w_cᵀ over camera
        v's costs (B6 over camera runs), and the A_rr-only blocks
        (A_rr + λI)[v,v]."""
        a_rr, _, _, _, wparts = sys
        _, offs, dof = self.fam_offsets[0]
        n_r, dl = len(offs), self.dof_elim
        ar = torch.arange(n_r, device=a_rr.device)
        a_blocks = (
            a_rr.view(n_r, dof, n_r, dof)[ar, :, ar, :]
            + lam * torch.eye(dof, dtype=a_rr.dtype, device=a_rr.device)
        )
        hi = torch.cat([h_inv.permute(2, 0, 1), h_inv.new_zeros(1, dl, dl)])
        corr = None
        for wp in wparts:
            m = torch.einsum("bpd,bde,bqe->bpq", wp.w_blk, hi[wp.lid], wp.w_blk)
            m = m.reshape(-1, dof * dof).index_select(0, wp.cperm)
            part = self.segment_sum(m, wp.cstarts)  # [n_r, dof²]
            corr = part if corr is None else corr + part
        return a_blocks - corr.reshape(n_r, dof, dof), a_blocks

    def precond_inverses(self, sys, lam, h_inv):
        """Inverted preconditioner blocks, each falling back to its
        A_rr-only inverse when the corrected one comes out non-finite
        (λ = 0 on gauge-deficient problems)."""
        blocks, a_blocks = self.precond_blocks(sys, lam, h_inv)
        inv = batched_inv_spd(blocks)
        bad = ~torch.isfinite(inv).flatten(1).all(1)
        return torch.where(bad[:, None, None], batched_inv_spd(a_blocks), inv)

    @staticmethod
    def damped_inverse(h_ll, lam):
        """(h_ll + λI)⁻¹ components-major, by the closed form computed in
        float64 and returned in h_ll's dtype.  On a float32 BAL problem
        some landmark blocks are singular to working precision (the
        Dubrovnik-class problem at its eighth iteration: eigenvalues ~1e4
        and ~1e-4 against λ ~3e-4), and the float32 determinant rounds to
        zero: an infinite inverse, then a NaN step.  The JAX package forms
        it in float32 and passes that point by rounding luck."""
        eye = torch.eye(h_ll.shape[0], dtype=torch.float64, device=h_ll.device)
        return batched_inv_spd_cm(h_ll.double() + lam * eye[:, :, None]).to(h_ll.dtype)

    def _finalize(self, xr, xl):
        """The full step from the reduced part and the components-major
        [dl, L] landmark part, in the flat variable-major order."""
        return torch.cat([xr, xl.T.reshape(-1)])

    def solve(self, sys, lam):
        """x with (H + λI) x = g: PCG on the reduced system, then the
        landmark back-substitution.  The PCG body is the JAX package's,
        updates frozen once converged; the host reads the convergence flag
        and the iteration count once every :data:`CG_CHECK_EVERY`
        iterations."""
        _, b_r, h_ll, g_l, wparts = sys
        dtype, dev = b_r.dtype, b_r.device
        h_inv = self.damped_inverse(h_ll, lam)
        rhs = b_r - self._w_apply(wparts, torch.einsum("del,el->dl", h_inv, g_l))
        inv = self.precond_inverses(sys, lam, h_inv)

        def precond(r):
            return torch.einsum("nst,nt->ns", inv, r.view(inv.shape[0], -1)).reshape(-1)

        tol2 = torch.tensor(self._tol(dtype), dtype=dtype, device=dev) ** 2 * (rhs @ rhs)
        one = torch.ones((), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        x, r = torch.zeros_like(rhs), rhs
        z = p = precond(r)
        rz = r @ z
        k = torch.zeros((), dtype=torch.int32, device=dev)
        more = True
        while more:
            for _ in range(CG_CHECK_EVERY):
                active = (r @ r > tol2) & (k < CG_MAX_ITERS)
                ap = self.s_matvec(sys, h_inv, lam, p)
                denom = p @ ap
                alpha = torch.where(active, rz / torch.where(denom == 0, one, denom), zero)
                x = x + alpha * p
                r = r - alpha * ap
                z2 = precond(r)
                rz2 = r @ z2
                beta = rz2 / torch.where(rz == 0, one, rz)
                p = torch.where(active, z2 + beta * p, p)
                z = torch.where(active, z2, z)
                rz = torch.where(active, rz2, rz)
                k = k + active.to(k.dtype)
            more, iters = torch.stack(
                [((r @ r > tol2) & (k < CG_MAX_ITERS)).to(dtype), k.to(dtype)]
            ).tolist()
        self.cg_iters.append(int(iters))
        xl = torch.einsum("del,el->dl", h_inv, g_l - self._wt_apply(wparts, x))
        return self._finalize(x, xl)
