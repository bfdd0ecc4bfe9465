"""Schur-complement (landmark-eliminated) solves: host layout, the direct
path and the implicit path.  Port of ``nllstpu/ops/schur.py``.

The direct path takes one of two routes, decided as the JAX package
decides its p-major route (:func:`route_batches`):

* the obs-major route, when one components-major camera/landmark batch
  produces W and its cameras are the whole reduced space: that batch is
  assembled by kernel B1 (one bucket) or B2 (degree buckets), or on the
  dual-sorted route by kernel B8 and a camera-major leg; its costs on fixed
  landmarks (the extras region) add their camera rows through kernel B6;
  priors and pure-reduced batches ride along on the generic sums; the
  damped reduced solve goes through kernel B3 in float32 and through
  kernel B4 over float64-formed inverses otherwise;
* the generic route (the JAX package's generic fall-through): every batch
  form, at most one eliminated slot per cost, any number of reduced
  families; the per-cost blocks of ``engine.batch_grad_hess`` summed per
  key in an order fixed at compile time by kernel B6, W placed by kernel
  B7, the reduced solve through kernel B5 over external inverses.  A
  components-major batch with one shared adaptive kernel takes its own run
  tables (kernels B6 and B7) on this route; per-cost kernels and the other
  adaptive batch forms take the generic sums, the kernel family one more
  reduced family.

The implicit path (:class:`SchurCGOps`: every keyed reduction through
kernel B6, the reduced system solved by PCG without forming S, with the
Schur-Jacobi or the cluster-Jacobi preconditioner) takes the same
batches, sorted by landmark; an adaptive batch's kernel rows ride its
coupling blocks beside the camera's.

Block structure, with r = reduced (camera) and l = eliminated (landmark)
tangent dims:

    [A_rr  W ] [x_r]   [b_r]      S x_r = b_r − W H_ll⁻¹ g_l
    [Wᵀ  H_ll] [x_l] = [g_l]  →   S = A_rr − W H_ll⁻¹ Wᵀ
                                  x_l = H_ll⁻¹ (g_l − Wᵀ x_r)

``h_ll [dl, dl, L]`` and ``g_l [dl, L]`` keep the JAX package's
components-major layout; W is landmark-major ``[L, dl, Dr]`` in the
standard basis (on the obs-major route the c-th unfixed camera owns
columns ``c·dr_s .. c·dr_s + dr_s − 1``, which are its reduced rows; fixed
variables have none).  The flat step vector is variable-major, as in the
JAX package.  A fixed variable is a dustbin: a fixed landmark's id is
``L``, a fixed reduced variable's row ``Dr``, and neither is written.

The host-side layout code (obs-major repack, bucket plan, degree counts)
is copied from the JAX package, which cannot be imported without jax.  A
uniform layout (one bucket) is assembled by kernel B1; a degree-bucketed
layout (skewed track lengths, as in real BAL data) by one launch of kernel
B2 over the whole batch, which takes each landmark's slots from every
bucket through compile-time tables.  Both write each observation's camera
terms to its own row in camera order, and kernel B6 sums the camera runs,
so the system repeats its bits.  The
dual-sorted route (``w_impl="fused"``, uniform layouts only) replaces B1
by kernel B8, which writes h_ll, g_l and W, and a second Jacobian
evaluation over the batch repacked into camera runs, whose plain sums
give a_rr and b_r.

The implicit path (:class:`SchurCGOps`) never stores W.  Its batches are
sorted by landmark at compile time (the reference's
``reordercostsforschur!``), the layout kernel B6 was written for.
Landmark-keyed sums (h_ll, g_l, Wᵀv) are B6 over the landmark runs;
variable-keyed sums (a_rr, b_r, W u, the preconditioner's correction) B6
over each reduced family's variable runs.  The JAX package's obs-major
repack of implicit batches existed only because lane-axis gathers are
slow on the TPU and is not carried over.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import engine
from ..core.linearsolver import (
    batched_inv_spd, batched_inv_spd_cm, cholesky_solve, cholesky_solve_ex, lu_solve,
    pcg_chunk, pcg_start,
)
from ..core.problem import family_name
from . import fused_obs, schur_reduce, w_place
from .segment_sum import segment_block_sum

#: Reduced-PCG iteration cap (the JAX package's ``SchurCGOps.max_iters``).
CG_MAX_ITERS = 500

#: Obs-major repack guards (as in the JAX package): largest uniform run
#: length, largest camera run of the camera repack, and the largest
#: padded-columns-to-real-costs ratio.
_FAST_MAX_K = 512
_FAST_MAX_CAM_K = 8192
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


def check_elim_slots(batches, info) -> None:
    """Raise ``ValueError`` where a cost touches the eliminated family
    twice, as the JAX package's ``assemble_schur`` does."""
    for b in batches:
        if len(_elim_slots(b, info)) > 1:
            raise ValueError(
                "Schur elimination requires at most one eliminated variable "
                "per cost (reference src/problem.jl:185)"
            )


def _coupling_slots(batch, info):
    """``(e, r)``, the eliminated and the reduced slot of a camera/landmark
    batch — two slots, or three with an adaptive kernel's variable in slot
    0 (the JAX package's ``adaptive3``) — or None."""
    elim = _elim_slots(batch, info)
    if len(elim) != 1 or info.num_elim == 0:
        return None
    e = elim[0]
    if len(batch.manifolds) == 2:
        return e, 1 - e
    if len(batch.manifolds) == 3 and batch.adaptive and e != 0:
        return e, 3 - e
    return None


def _apply_take(batch, take, newmask):
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i)[take] for i in batch.idx),
        params=None if batch.params is None else np.asarray(batch.params)[take],
        mask=newmask,
        take=np.asarray(take) if batch.take is None else np.asarray(batch.take)[take],
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


def residual_rows(batch) -> int:
    """Residual rows of a components-major batch without an adaptive
    kernel (the JAX package's ``_batch_nres``): its residual on one column
    of meta tensors (shapes only, no arithmetic), or on one column of ones
    on the CPU where an operation of the residual has no meta kernel."""
    params = None if batch.params is None else np.asarray(batch.params)[:1]

    def rows_on(dev):
        vals = [torch.ones(int(np.prod(m.shape, dtype=np.int64)), 1, dtype=torch.float64,
                           device=dev) for m in batch.manifolds]
        p = None if params is None else torch.as_tensor(params, dtype=torch.float64).to(dev)
        return int(torch.atleast_2d(batch.fn(p, *vals)).shape[0])

    try:
        return rows_on("meta")
    except (NotImplementedError, RuntimeError):
        return rows_on("cpu")


def route_batches(batches, info: "SchurInfo", layout, dtype):
    """The direct solve's route and batch order, decided as the JAX
    package's ``_w_pm_data`` decides its p-major route.  The obs-major
    route (kernels B1/B2, or B8 on the dual-sorted route) is taken when
    exactly one batch produces W (more than one slot, one of them
    eliminated), that batch is a two-slot components-major batch without
    an adaptive kernel whose :func:`obs_major_repack` qualifies, its
    camera family's unfixed variables are the whole reduced space, and
    kernels B1, B2 and B8 take its shape (residual rows, camera dof,
    landmark dof) in ``dtype`` (:func:`fused_obs.kernel_takes`, asked on
    every device, so that a CPU compile records the route a card compile
    takes); point priors and pure-reduced batches (camera priors,
    pose-graph edges) ride along on the generic sums.  Anything else takes
    the generic route, every batch sorted by landmark
    (:func:`sort_for_implicit`).  Returns ``(batches, buckets_per_batch,
    route)``: ``route`` the index of the obs-major batch or None,
    ``buckets`` None for every other batch."""
    sort = [sort_for_implicit(b, info) for b in batches]
    none = [None] * len(batches)
    if info.num_elim == 0 or info.dim_reduced == 0 or any(b.adaptive for b in batches):
        return sort, none, None
    producing = [bi for bi, b in enumerate(batches)
                 if len(b.manifolds) > 1 and _elim_slots(b, info)]
    if len(producing) != 1:
        return sort, none, None
    (bi,) = producing
    b = batches[bi]
    if b.batched != "cm" or len(b.manifolds) != 2:
        return sort, none, None
    rman = b.manifolds[1 - _elim_slots(b, info)[0]]
    rfam = family_name(rman)
    cols = (np.asarray(layout.offsets[rfam])[layout.unfixed[rfam]][:, None]
            + np.arange(rman.dof)).reshape(-1)
    if not np.array_equal(np.sort(cols), np.arange(info.dim_reduced)):
        return sort, none, None
    n_res = residual_rows(b)
    if not fused_obs.kernel_takes(n_res, rman.dof, info.dof_elim, dtype):
        info.generic_why = (
            f"kernels B1, B2 and B8 do not take its shape (n={n_res}, dr_s={rman.dof}, "
            f"dl={info.dof_elim}, {dtype}: "
            f"{fused_obs.refusal(n_res, rman.dof, info.dof_elim, dtype)}), so the problem "
            "takes the generic route"
        )
        return sort, none, None
    nb, bk = obs_major_repack(b, info)
    if nb is None:
        return sort, none, None
    sort[bi], none[bi] = nb, bk
    return sort, none, bi


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
    eliminated slot).  W's column blocks and the camera rows are keyed by
    the UNFIXED cameras in layout order (camera column ``c`` owns W
    columns ``c·dr_s .. c·dr_s + dr_s − 1``), so W spans the reduced space
    exactly: the JAX package's p-major layout and its ``pm_of_std`` basis
    gather were a TPU workaround."""

    e_slot: int  # eliminated dependency slot
    r_slot: int  # reduced (camera) dependency slot
    n_r: int  # unfixed cameras: W's column blocks
    dr_s: int  # camera dof
    rvid: np.ndarray  # [B] camera column (n_r = dustbin: masked cost, fixed camera)
    row_base: np.ndarray  # [n_r] global tangent offset per camera column
    buckets: tuple  # ((l_base, L_b, k_b, col_base), ...)
    # The camera side of B1/B2 (fused_obs.camera_order over ``rvid`` of the
    # buckets' columns): each column's row in the camera-sorted order of
    # the non-dustbin columns (−1 for the dustbin and the extras) and each
    # camera's run of that order.
    cam_pos: np.ndarray  # [B] int32
    cam_starts: np.ndarray  # [n_r+1] int32
    lid: np.ndarray  # [B] landmark of each column (L = pad)
    # The extras region (the JAX package's ``_onehot_reduced_tail``): the
    # columns of real costs whose landmark is fixed and camera unfixed,
    # sorted by camera column, and each camera's run of them.  Their camera
    # rows are summed by kernel B6 beside B1's and B2's.
    ex_cols: np.ndarray  # [n_ex] int
    ex_starts: np.ndarray  # [n_r+1] int32
    # Kernel B2's work list over the columns (fused_obs.slot_tables; host
    # until upload_tables places it on the device), for a bucketed layout.
    slots: Any = None
    # Dual-sorted route (``w_impl="fused"``): the batch repacked into camera
    # runs (:func:`_cam_major_repack`; host until upload_tables places it on
    # the device) and its run length, or None.
    cam_batch: Any = None
    cam_k: Optional[int] = None
    vc_all: Any = None  # device int32 [B]: rvid (kernel B2's)
    cpos_all: Any = None  # device int32 [B]: cam_pos (kernel B2's)
    vc: Any = None  # one bucket: device int32 [K, L] view of vc_all (B1's, B8's tile)
    cpos: Any = None  # one bucket: device int32 [K, L] view of cpos_all (B1's)
    cstarts: Any = None  # device int32 [n_r+1]: cam_starts
    pair_of: Any = None  # device [dr_s²]: ab row of a_rr entry (p, q)
    rows: Any = None  # device [n_r, dr_s]: reduced rows of each camera column
    ex_idx: Any = None  # device long [n_ex]: ex_cols
    ex_cstarts: Any = None  # device int32 [n_r+1]: ex_starts


def _fast_batch_data(batch, layout, info, buckets=None):
    """Fast-path tables of one repacked batch, or None when the batch is
    not an obs-major two-slot BA batch.  The costs of fixed cameras go to
    the dustbin column: they add to h_ll and g_l only; those of fixed
    landmarks (the extras after the buckets) to a_rr and b_r only.  On the
    dual-sorted route (``info.w_impl == "fused"``) a single-bucket batch
    also gets its camera repack, which holds the extras too."""
    elim = _elim_slots(batch, info)
    if buckets is None or len(elim) != 1 or len(batch.manifolds) != 2:
        return None
    e = elim[0]
    r_slot = 1 - e
    rfam = family_name(batch.manifolds[r_slot])
    unfixed = layout.unfixed[rfam]
    n_r = int(unfixed.sum())
    col_of = np.full(unfixed.shape[0], n_r, dtype=np.int32)
    col_of[unfixed] = np.arange(n_r, dtype=np.int32)
    rvid = col_of[np.asarray(batch.idx[r_slot])]
    rvid[~np.asarray(batch.mask)] = n_r
    cam_batch = cam_k = None
    if info.w_impl == "fused" and len(buckets) == 1:
        cam_batch, cam_k = _cam_major_repack(batch, rvid, n_r)
    lid = _landmark_ids(batch, info, e)
    extra = np.asarray(batch.mask) & (lid == info.num_elim) & (rvid < n_r)
    cam_pos, cam_starts = fused_obs.camera_order(np.where(extra, n_r, rvid), n_r)
    ex = np.nonzero(extra)[0]
    ex_cols = ex[np.argsort(rvid[ex], kind="stable")]
    ex_starts = np.concatenate([[0], np.cumsum(np.bincount(rvid[ex], minlength=n_r))])
    slots = None
    if len(buckets) > 1 and info.w_impl == "fused_all":
        t0 = time.perf_counter()
        slots = fused_obs.slot_tables(lid, rvid, info.num_elim, n_r)
        info.table_seconds += time.perf_counter() - t0
    return _FastBatch(
        e_slot=e,
        r_slot=r_slot,
        n_r=n_r,
        dr_s=batch.manifolds[r_slot].dof,
        rvid=rvid,
        row_base=np.asarray(layout.offsets[rfam])[unfixed].astype(np.int32),
        buckets=buckets,
        cam_pos=cam_pos,
        cam_starts=cam_starts,
        lid=lid,
        ex_cols=ex_cols,
        ex_starts=ex_starts.astype(np.int32),
        slots=slots,
        cam_batch=cam_batch,
        cam_k=cam_k,
    )


def _cam_major_repack(batch, rvid, n_r):
    """Camera-run repack of an obs-major batch (the JAX package's
    ``_cam_major_repack``): column ``c·Kc + j`` holds the j-th cost of
    camera column ``c``; costs with a dustbin ``rvid`` (masked, or a fixed
    camera: no a_rr contribution) are dropped.  Returns ``(batch, Kc)``,
    or ``(None, None)`` past the skew limits.  Fixed cameras have no run
    here (the JAX package pads them with empty ones), so the padded ratio
    counts only the unfixed cameras' runs."""
    if n_r == 0:
        return None, None
    rows_sorted, skey, _, pos, kc = _group_rows(rvid, n_r)
    if kc > _FAST_MAX_CAM_K or n_r * kc > _OBS_MAJOR_MAX_RATIO * max(len(rows_sorted), 1):
        return None, None
    cols = skey * kc + pos
    take = np.zeros(-(-(n_r * kc) // 8) * 8, dtype=np.int64)
    newmask = np.zeros(take.shape[0], dtype=bool)
    take[cols] = rows_sorted
    newmask[cols] = True
    return _apply_take(batch, take, newmask), kc


class WPart(NamedTuple):
    """Per-batch coupling part of the implicit system: the per-cost
    coupling blocks in landmark-sorted order and the device tables that
    key them (without ``w_blk``, the keys of any landmark-sorted batch)."""

    w_blk: Any  # [B, Sr, dl] coupling block of each cost (zero when masked)
    rows_r: Any  # [B, Sr] reduced row of each block row (Dr = dustbin)
    lid: Any  # [B] landmark id of each cost (L = dustbin)
    lstarts: Any  # int32 [L+1] landmark runs of the sorted costs
    cperm: Any = None  # [Nc] rows of the real costs, in camera order (camera/landmark batches)
    cstarts: Any = None  # int32 [n_r+1] camera runs of ``cperm``


@dataclasses.dataclass
class _RunBatch:
    """Host tables of a landmark-sorted camera/landmark batch: the implicit
    backend's components-major batches, and the direct path's adaptive
    batch (with its kernel's rows).  The camera columns are the unfixed
    cameras of the batch's camera family, in layout order; a fixed camera's
    costs go to the dustbin column ``n_r``."""

    e_start: int  # offset of the eliminated slot in the Jacobian's tangent
    n_r: int  # unfixed cameras: the camera columns
    dr_s: int  # reduced (camera) dof
    row_base: np.ndarray  # [n_r] global tangent offset per camera column
    lid: np.ndarray  # [B] landmark id per sorted cost (L for masked ones)
    rvid: np.ndarray  # [B] camera column per sorted cost (n_r: masked, fixed camera)
    lstarts: np.ndarray  # int32 [L+1]
    cperm: np.ndarray  # [Nc] sorted rows of the real costs, camera-stable order
    cstarts: np.ndarray  # int32 [n_r+1]
    rfam: str = ""  # the camera family
    # Reduced rows of the shared adaptive kernel's parameters (the JAX
    # package's ``kernel_rows``), or None for a fixed kernel or variable.
    kernel_rows: Optional[np.ndarray] = None
    keys: Any = None  # device WPart without w_blk (upload_tables)
    pair_of: Any = None  # device [dr_s²]: ab row of a_rr entry (p, q)
    rows: Any = None  # device [n_r, dr_s]: reduced rows of each camera
    colbase: Any = None  # device int32 [B]: W column of each cost's camera, −1 dropped
    kr: Any = None  # device [k]: kernel_rows


@dataclasses.dataclass
class _GenBatch:
    """Host tables of a batch on the generic route (the JAX package's
    generic fall-through of ``assemble_schur``): any batch form, at most
    one eliminated slot, its per-cost blocks from
    ``engine.batch_grad_hess``.  ``sel_r`` are the block columns of its
    reduced slots, ``sel_e`` those of its eliminated slot (None for a
    pure-reduced batch: a camera prior, a pose-graph edge).  A cost's
    landmark is the dustbin ``L`` when it is masked, its landmark is fixed
    or it has none; a reduced column's row the dustbin ``Dr`` when its cost
    is masked or its variable fixed.  The batch is sorted by landmark."""

    sel_r: np.ndarray  # [Sr]
    sel_e: Optional[np.ndarray]  # [dl] or None
    # Per reduced slot: (first column in sel_r, family, dof, position of
    # each cost's variable in its family's unfixed range, −1 dropped).
    slots: tuple
    two_slot: bool  # one reduced slot beside the eliminated one
    lid: np.ndarray  # [B]
    rows_r: np.ndarray  # [B, Sr]
    lstarts: np.ndarray  # int32 [L+1]
    sel: Any = None  # device (sel_r, sel_e)
    keys: Any = None  # implicit: device WPart without w_blk


class _Sum(NamedTuple):
    """One fixed-order keyed sum of per-cost rows: the rows of each
    source ``(part, first column)`` concatenated in source order, taken in
    the order ``perm`` (None: as they are) and summed over the runs
    ``starts`` by kernel B6.  ``out`` says where the sums land (its
    owner's)."""

    sources: tuple
    perm: Any
    starts: Any
    out: Any


@dataclasses.dataclass
class _GenericPlan:
    """The keyed sums of the generic batches' per-cost blocks, in an order
    fixed at compile time (``engine.dense_plan``'s and ``ops/cg.py``'s
    design: the same inputs give the same bits).  ``b``: b_r per reduced
    family (``out = (base, n, dof)``, its rows ``base .. base + n·dof −
    1``); ``a``: a_rr per ordered pair of reduced families, keyed by the
    variable pair (``out`` each key's rows of the two variables); ``l``:
    h_ll and g_l over landmark runs; ``w``: W per slot width, placed by
    kernel B7 (``out`` each row's first W column, −1 dropped).  Sources
    are batch indices.  ``w_inc``: W's (landmark, first column, width)
    incidences, host arrays for :func:`w_structure`."""

    b: tuple = ()
    a: tuple = ()
    l: Optional[_Sum] = None
    w: tuple = ()
    w_inc: tuple = ()


@dataclasses.dataclass
class _ImplicitPlan:
    """The implicit solve's keyed sums over its coupling parts (``parts``:
    the batch index of each part, in order): ``vec`` the W u sums per
    reduced family (``out = (base, n, dof)``, every family, None where no
    part sees it), ``corr`` the preconditioner's Schur correction per
    family, from the two-slot parts only (None: the family keeps its
    A_rr-only blocks), as the JAX package's ``SchurCGOps.precond_blocks``
    corrects them."""

    parts: tuple = ()
    vec: tuple = ()
    corr: tuple = ()


@dataclasses.dataclass
class SchurInfo:
    """Static structure of the Schur system.  ``implicit`` selects the
    matrix-free solve (:class:`SchurCGOps`); otherwise the direct solve
    over a dense W (:class:`SchurOps`).  ``fast`` holds each batch's
    tables: :class:`_FastBatch` for the obs-major batch (kernels B1/B2 or
    B8), :class:`_RunBatch` for an adaptive batch of the direct solve and a
    components-major camera/landmark batch of the implicit one, and
    :class:`_GenBatch` for any other (the generic sums of ``plan``)."""

    elim_family: str
    dim_reduced: int  # Dr
    num_elim: int  # L
    dof_elim: int  # dl
    elim_ids: dict  # family name -> [n] landmark ids (num_elim: fixed)
    fast: tuple = ()  # per batch: _FastBatch, _RunBatch or _GenBatch
    implicit: bool = False
    # Direct assembly route of the obs-major batch: "fused_all" (kernels
    # B1/B2) or "fused" (the dual-sorted route: kernel B8 and the
    # camera-major leg).
    w_impl: str = "fused_all"
    # Reduced families with unfixed variables, (name, base, n, dof) in
    # tangent order: each fills rows base .. base + n·dof − 1.
    fams: tuple = ()
    plan: Any = None  # _GenericPlan of the _GenBatch batches
    cg: Any = None  # _ImplicitPlan (implicit)
    # Kernel B5's structure of the generic W (schur_reduce.RowTables; host
    # until upload_tables places it on the device), else None.
    w_pairs: Any = None
    # Kernels B3's and B4's structure of an obs-major W (the obs-major
    # route; schur_reduce.RowTables; host until upload_tables), else None.
    w_rows: Any = None
    # Host seconds spent building kernel B2's, B3/B4's and B5's tables.
    table_seconds: float = 0.0
    # Why the coupling batch takes the generic route where that is its
    # shape (:func:`route_batches`), else "".
    generic_why: str = ""
    # Implicit: the one coupling part that cluster-Jacobi can take
    # (:func:`_cluster_source`: ``(lid, rvid, n_r, dr_s)`` host arrays),
    # else None; and its plans per cluster size (cluster_plan).
    cluster_src: Any = None
    clusters: dict = dataclasses.field(default_factory=dict)


def _reduced_families(problem, layout, elim_fam: str) -> tuple:
    """``(name, base, n, dof)`` of every reduced family with unfixed
    variables, in tangent order (``engine.build_layout`` gives a family's
    unfixed variables one range, the eliminated family's last)."""
    out = []
    for name in problem.family_names():
        off = np.asarray(layout.offsets[name])
        held = off[off < layout.dof_total]
        if name != elim_fam and held.size:
            out.append((name, int(held.min()), int(held.size), problem.manifold_of(name).dof))
    return tuple(sorted(out, key=lambda f: f[1]))


def build_schur_info(problem, layout, elim_manifold, batches=None,
                     buckets=None, implicit: bool = False,
                     w_impl: str = "fused_all", route=None) -> SchurInfo:
    """Reduced/eliminated split of a layout built with the eliminated family
    ordered last (a fixed landmark's id is ``num_elim``, the dustbin); with
    ``batches`` (ordered by :func:`route_batches` for the direct solve,
    :func:`sort_for_implicit` for the implicit one), also each batch's
    tables, the generic sums' plan and W's block tables.  ``route`` is the
    obs-major batch's index (direct solve), or None."""
    elim_fam = family_name(elim_manifold)
    dl = elim_manifold.dof
    offs = np.asarray(layout.offsets[elim_fam])
    unfixed = layout.unfixed[elim_fam]
    num_elim = int(unfixed.sum())
    dim_reduced = layout.dof_total - num_elim * dl
    ids = np.full(offs.shape[0], num_elim, dtype=np.int32)
    ids[unfixed] = (offs[unfixed] - dim_reduced) // dl
    info = SchurInfo(
        elim_family=elim_fam,
        dim_reduced=dim_reduced,
        num_elim=num_elim,
        dof_elim=dl,
        elim_ids={elim_fam: ids},
        implicit=implicit,
        w_impl=w_impl,
        fams=_reduced_families(problem, layout, elim_fam),
    )
    if batches is not None:
        fill_tables(info, layout, batches, buckets, route)
    return info


def fill_tables(info: SchurInfo, layout, batches, buckets=None, route=None) -> None:
    """Each batch's tables, the generic sums' plan and W's block tables
    (the implicit plan for the implicit solve) of ``info``, whose landmark
    numbering (``num_elim``, ``elim_ids``) the batches are laid out in: the
    second half of :func:`build_schur_info`, also run on a rank's shard
    with its local numbering (``parallel.schur_shard``)."""
    implicit = info.implicit
    per_batch = buckets if buckets is not None else [None] * len(batches)
    fast = []
    for bi, (b, bk) in enumerate(zip(batches, per_batch)):
        f = None
        if bi == route and not implicit:
            f = _fast_batch_data(b, layout, info, buckets=bk)
        elif b.batched == "cm" and b.adaptive != implicit:
            # The direct path's adaptive batch; a components-major
            # camera/landmark batch of the implicit one.
            f = _run_batch_data(b, layout, info)
        fast.append(f if f is not None else _gen_batch_data(b, layout, info))
    info.fast = tuple(fast)
    info.plan = _generic_plan(info)
    if implicit:
        info.cg = _implicit_plan(info)
        info.cluster_src = _cluster_source(info, batches, layout)
    else:
        t0 = time.perf_counter()
        tables = w_structure(info)
        if route is None:
            info.w_pairs = tables
        else:
            info.w_rows = tables
        info.table_seconds += time.perf_counter() - t0


def w_structure(info: SchurInfo) -> schur_reduce.RowTables:
    """Kernels B3's, B4's and B5's tables of the direct W
    (:func:`schur_reduce.row_tables`).  An obs-major W has one block per
    unfixed camera, its ``dr_s`` compact columns (cut into pieces of at
    most ``schur_reduce.MAX_WIDTH`` columns); the generic W one block
    per reduced variable that its coupling costs see (its rows, cut into
    blocks of at most ``schur_reduce.MAX_WIDTH`` columns) and one per
    adaptive kernel (its rows).  A landmark holds the blocks of the
    variables its real costs see, in every batch.  Fixed variables and
    pads hold none."""
    L = info.num_elim
    lmk, col, width = [], [], []
    obs_major = None
    for f in info.fast:
        if isinstance(f, _GenBatch):
            continue
        real = (f.lid < L) & (f.rvid < f.n_r)
        lmk.append(f.lid[real])
        if isinstance(f, _FastBatch):
            obs_major = (f.n_r, f.dr_s)
            col.append(f.rvid[real].astype(np.int64) * f.dr_s)  # compact camera columns
        else:
            col.append(np.asarray(f.row_base, dtype=np.int64)[f.rvid[real]])
        width.append(np.full(lmk[-1].shape[0], f.dr_s))
        kr = getattr(f, "kernel_rows", None)
        if kr is not None:
            held = np.unique(f.lid[f.lid < L])
            lmk.append(held)
            col.append(np.full(held.shape[0], kr[0], dtype=np.int64))
            width.append(np.full(held.shape[0], kr.shape[0]))
    for lm, c, w in info.plan.w_inc:
        lmk.append(lm)
        col.append(c)
        width.append(w)
    lmk = np.concatenate(lmk) if lmk else np.zeros(0, np.int64)
    col = np.concatenate(col) if col else np.zeros(0, np.int64)
    width = np.concatenate(width) if width else np.zeros(0, np.int64)
    # Blocks wider than the kernels take are cut into pieces.
    mw = schur_reduce.MAX_WIDTH
    if obs_major is not None:
        n_r, dr_s = obs_major
        bcol, bwidth = schur_reduce.uniform_blocks(n_r, dr_s)
        n_pc = -(-dr_s // mw)  # each camera's pieces, adjacent
        blk = (col // dr_s)[:, None] * n_pc + np.arange(n_pc)
        return schur_reduce.row_tables(np.repeat(lmk, n_pc), blk.reshape(-1), L, bcol, bwidth)
    n_pc = -(-width // mw)
    rep = np.repeat(np.arange(lmk.shape[0]), n_pc)
    k = np.arange(rep.shape[0]) - np.repeat(np.cumsum(n_pc) - n_pc, n_pc)
    lmk, col, width = lmk[rep], col[rep] + k * mw, np.minimum(width[rep] - k * mw, mw)
    bcol, first, blk = np.unique(col, return_index=True, return_inverse=True)
    bwidth = width[first]
    if np.any(width != bwidth[blk]):
        raise ValueError("two column blocks of W start at one column")
    return schur_reduce.row_tables(lmk, blk, L, bcol, bwidth)


def _landmark_ids(batch, info, e):
    """Landmark id per cost, ``L`` (the dustbin) for masked ones."""
    lid = np.asarray(info.elim_ids[info.elim_family])[np.asarray(batch.idx[e])]
    return np.where(np.asarray(batch.mask), lid, info.num_elim)


def sort_for_implicit(batch, info: SchurInfo):
    """The batch with its costs sorted by landmark id, masked costs and
    those of fixed landmarks last (the JAX package's ``_elim_sort_data``,
    the reference's ``reordercostsforschur!``); a batch without exactly one
    eliminated slot is returned as it is."""
    elim = _elim_slots(batch, info)
    if len(elim) != 1 or info.num_elim == 0:
        return batch
    perm = np.argsort(_landmark_ids(batch, info, elim[0]), kind="stable")
    return _apply_take(batch, perm, np.asarray(batch.mask)[perm])


def _runs(keys, n):
    """int32 ``[n + 1]`` run starts of the sorted ``keys`` (all < n)."""
    return np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=n))]).astype(np.int32)


def _positions(batch, layout, info, slot):
    """Position of each cost's variable in slot ``slot`` within its
    family's unfixed range (:attr:`SchurInfo.fams`), −1 where the cost is
    masked or the variable fixed; and the family's ``(base, n, dof)``."""
    name = family_name(batch.manifolds[slot])
    ((base, n, dof),) = [f[1:] for f in info.fams if f[0] == name] or [(0, 0, 1)]
    off = np.asarray(layout.offsets[name])[np.asarray(batch.idx[slot])]
    ok = np.asarray(batch.mask) & (off < layout.dof_total)
    return np.where(ok, (off - base) // dof, -1), (base, n, dof)


def _run_batch_data(batch, layout, info):
    """Run tables of a landmark-sorted camera/landmark batch
    (:func:`_coupling_slots`), or None.  An adaptive batch qualifies when
    one kernel variable serves all its costs; its kernel rows are that
    variable's, None when it is fixed.  Per-cost kernels take the generic
    route, where the kernel family is one more reduced family, as the JAX
    package's generic fall-through takes them."""
    slots = _coupling_slots(batch, info)
    if slots is None:
        return None
    e, r = slots
    L = info.num_elim
    lid = _landmark_ids(batch, info, e)
    if np.any(np.diff(lid) < 0):
        return None  # not sorted by sort_for_implicit
    mask = np.asarray(batch.mask)
    kernel_rows = None
    if batch.adaptive and np.unique(np.asarray(batch.idx[0])[mask]).size > 1:
        return None
    if batch.adaptive and mask.any():
        kman = batch.manifolds[0]
        kvar = np.asarray(batch.idx[0])[mask][0]
        koff = int(np.asarray(layout.offsets[family_name(kman)])[kvar])
        if koff < layout.dof_total:
            kernel_rows = koff + np.arange(kman.dof, dtype=np.int64)
    pos, (base, n_r, dr_s) = _positions(batch, layout, info, r)
    rvid = np.where(pos >= 0, pos, n_r)
    real = np.nonzero(rvid < n_r)[0]
    cperm = real[np.argsort(rvid[real], kind="stable")]
    return _RunBatch(
        # The Jacobian's tangent leaves out an adaptive kernel's slot 0.
        e_start=sum(m.dof for m in batch.manifolds[int(batch.adaptive) : e]),
        n_r=n_r,
        dr_s=batch.manifolds[r].dof,
        row_base=(base + dr_s * np.arange(n_r)).astype(np.int32),
        lid=lid,
        rvid=rvid,
        lstarts=_runs(lid[lid < L], L),
        cperm=cperm,
        cstarts=_runs(rvid[real], n_r),
        rfam=family_name(batch.manifolds[r]),
        kernel_rows=kernel_rows,
    )


def _gen_batch_data(batch, layout, info) -> _GenBatch:
    """Generic tables of a landmark-sorted batch (:class:`_GenBatch`)."""
    elim = _elim_slots(batch, info)
    L, dr = info.num_elim, info.dim_reduced
    B = np.asarray(batch.mask).shape[0]
    lid = _landmark_ids(batch, info, elim[0]) if elim else np.full(B, L)
    held = {f[0] for f in info.fams}
    col, sr, sel_r, sel_e, slots, rows = 0, 0, [], None, [], []
    for s, m in enumerate(batch.manifolds):
        cols = np.arange(col, col + m.dof)
        col += m.dof
        if elim and s == elim[0]:
            sel_e = cols
            continue
        if family_name(m) not in held:
            continue  # a family with every variable fixed: no reduced rows
        pos, (base, _, dof) = _positions(batch, layout, info, s)
        slots.append((sr, family_name(m), dof, pos))
        sr += dof
        sel_r.append(cols)
        rows.append(np.where(pos[:, None] >= 0, base + pos[:, None] * dof + np.arange(dof), dr))
    return _GenBatch(
        sel_r=np.concatenate(sel_r) if sel_r else np.zeros(0, np.int64),
        sel_e=sel_e,
        slots=tuple(slots),
        two_slot=bool(elim) and len(batch.manifolds) == 2,
        lid=lid,
        rows_r=np.concatenate(rows, 1) if rows else np.zeros((B, 0), np.int64),
        lstarts=_runs(lid[lid < L], L),
    )


def _keyed(keys, n_keys):
    """``(perm, starts)``: the rows whose key lies in ``[0, n_keys)``
    sorted by key, stably (``perm`` None when that is every row in its
    order), and each key's run."""
    keys = np.asarray(keys, dtype=np.int64)
    keep = np.nonzero((keys >= 0) & (keys < n_keys))[0]
    perm = keep[np.argsort(keys[keep], kind="stable")]
    starts = np.concatenate([[0], np.cumsum(np.bincount(keys[perm], minlength=n_keys))])
    if perm.shape[0] == keys.shape[0] and np.array_equal(perm, np.arange(keys.shape[0])):
        perm = None
    return perm, starts


def _family_sums(parts, fams, only=None) -> tuple:
    """Per reduced family, the :class:`_Sum` of its slots' rows keyed by
    variable over ``parts`` (``(source index, slots)`` pairs, ``slots`` as
    :attr:`_GenBatch.slots`; ``only`` filters the sources), or None where
    no source holds the family."""
    out = []
    for name, base, n, dof in fams:
        src, keys = [], []
        for si, slots in parts:
            if only is not None and not only(si):
                continue
            for c, nm, _, pos in slots:
                if nm == name:
                    src.append((si, c))
                    keys.append(pos)
        if not src:
            out.append(None)
            continue
        perm, starts = _keyed(np.concatenate(keys), n)
        out.append(_Sum(tuple(src), perm, starts, (base, n, dof)))
    return tuple(out)


def _generic_plan(info: SchurInfo) -> _GenericPlan:
    """The :class:`_GenericPlan` of the batches ``info.fast`` marks
    generic."""
    gens = [(bi, f) for bi, f in enumerate(info.fast) if isinstance(f, _GenBatch)]
    L = info.num_elim
    fam_of = {name: (base, n, dof) for name, base, n, dof in info.fams}
    b = tuple(s for s in _family_sums([(bi, f.slots) for bi, f in gens], info.fams)
              if s is not None)
    # a_rr: every ordered pair of reduced slots, keyed by the variable pair.
    pairs = collections.defaultdict(lambda: ([], []))
    for bi, f in gens:
        for ca, na, _, pa in f.slots:
            for cb, nb, _, pb in f.slots:
                nbk = fam_of[nb][1]
                src, keys = pairs[(na, nb)]
                src.append((bi, ca, cb))
                keys.append(np.where((pa >= 0) & (pb >= 0), pa * nbk + pb, -1))
    a = []
    for (na, nb), (src, keys) in pairs.items():
        keys = np.concatenate(keys)
        uk = np.unique(keys[keys >= 0])
        perm, starts = _keyed(np.where(keys >= 0, np.searchsorted(uk, keys), -1), uk.shape[0])
        (ba, _, da), (bb, nbk, db) = fam_of[na], fam_of[nb]
        out = (ba + (uk // nbk)[:, None] * da + np.arange(da),
               bb + (uk % nbk)[:, None] * db + np.arange(db))
        a.append(_Sum(tuple(src), perm, starts, out))
    coupled = [(bi, f) for bi, f in gens if f.sel_e is not None]
    lsum = None
    if coupled:
        perm, starts = _keyed(np.concatenate([f.lid for _, f in coupled]), L)
        lsum = _Sum(tuple((bi, 0) for bi, _ in coupled), perm, starts, None)
    # W: one placement per slot width over every coupling slot of that width.
    by_width = collections.defaultdict(lambda: ([], [], []))
    for bi, f in coupled if not info.implicit else ():
        for c, name, dof, pos in f.slots:
            src, keys, cols = by_width[dof]
            src.append((bi, c, dof))
            keys.append(f.lid)
            cols.append(np.where(pos >= 0, fam_of[name][0] + pos * dof, -1))
    w, w_inc = [], []
    for dof, (src, keys, cols) in sorted(by_width.items()):
        keys, cols = np.concatenate(keys), np.concatenate(cols)
        perm, starts = _keyed(keys, L)
        colbase = cols if perm is None else cols[perm]
        w.append(_Sum(tuple(src), perm, starts, colbase.astype(np.int32)))
        real = (keys < L) & (cols >= 0)
        w_inc.append((keys[real], cols[real], np.full(int(real.sum()), dof)))
    return _GenericPlan(b=b, a=tuple(a), l=lsum, w=tuple(w), w_inc=tuple(w_inc))


def _implicit_plan(info: SchurInfo) -> _ImplicitPlan:
    """The :class:`_ImplicitPlan`: a coupling part per batch with an
    eliminated slot and reduced columns, in batch order."""
    parts, slots, two = [], [], []
    for bi, f in enumerate(info.fast):
        if isinstance(f, _RunBatch):
            parts.append(bi)
            pos = np.where(f.rvid < f.n_r, f.rvid, -1)
            slots.append([(0, f.rfam, f.dr_s, pos)])
            two.append(True)
        elif f.sel_e is not None and f.sel_r.shape[0]:
            parts.append(bi)
            slots.append(f.slots)
            two.append(f.two_slot)
    indexed = list(enumerate(slots))
    return _ImplicitPlan(
        parts=tuple(parts),
        vec=_family_sums(indexed, info.fams),
        corr=_family_sums(indexed, info.fams, only=lambda j: two[j]),
    )


class _ClusterPlan(NamedTuple):
    """Cluster-Jacobi's tables for ``m`` cameras per cluster (device):
    the pairs of costs of one landmark whose cameras share a cluster
    (``c1``, ``c2``, rows of the one coupling part), sorted by their target
    ``(cluster, local camera 1, local camera 2)`` (``perm``) with each
    target's run (``starts``); then ``n_cl`` clusters of ``m`` cameras of
    ``dof`` rows each."""

    c1: Any
    c2: Any
    perm: Any
    starts: Any
    n_cl: int
    m: int
    dof: int


def _cluster_source(info: SchurInfo, batches, layout):
    """The coupling part cluster-Jacobi can take, where the JAX package's
    ``SchurCGOps._cluster_layout`` takes one: one reduced family whose
    variables are all unfixed (contiguous offsets), and one coupling part
    in all, a components-major two-slot camera/landmark batch with a fixed
    kernel whose landmark runs are uniform (its obs-major repack is one
    bucket).  Returns ``(lid, rvid, n_r, dr_s)`` or None."""
    if len(info.fams) != 1 or len(info.cg.parts) != 1:
        return None
    (bi,) = info.cg.parts
    f, b = info.fast[bi], batches[bi]
    if not isinstance(f, _RunBatch) or b.adaptive or len(b.manifolds) != 2:
        return None
    if not layout.unfixed[f.rfam].all():
        return None
    _, buckets = obs_major_repack(b, info)
    if buckets is None or len(buckets) != 1:
        return None
    return f.lid, f.rvid, f.n_r, f.dr_s


def cluster_plan(info: SchurInfo, m: int, device) -> Optional[_ClusterPlan]:
    """Cluster-Jacobi's :class:`_ClusterPlan` for ``m`` consecutive
    cameras per cluster (``Options.schur_cluster_size``), built once per
    size; None where it does not apply (``m`` ≤ 0, no
    :attr:`SchurInfo.cluster_src`, or more than 64 clusters, the JAX
    package's limit): the solve keeps Schur-Jacobi, as the JAX package
    falls back.  The JAX package builds each cluster's block with a
    W-sized one-hot contraction per cluster; here the in-cluster camera
    pairs of each landmark are listed once on the host (at the first
    ``ctx`` with that size), and their products summed per target by
    kernel B6."""
    if m <= 0 or info.cluster_src is None:
        return None
    if m not in info.clusters:
        lid, rvid, n_r, dr_s = info.cluster_src
        n_cl = -(-n_r // m)
        plan = None
        if n_cl <= 64:
            real = np.nonzero((lid < info.num_elim) & (rvid < n_r))[0]
            cl = rvid[real] // m
            o = real[np.lexsort((rvid[real], cl, lid[real]))]
            key = lid[o].astype(np.int64) * n_cl + rvid[o] // m
            first = np.r_[True, key[1:] != key[:-1]]
            gid = np.cumsum(first) - 1
            gstart = np.nonzero(first)[0]
            gsize = np.diff(np.r_[gstart, o.shape[0]])
            rep = gsize[gid]
            c1 = np.repeat(o, rep)
            k = np.arange(c1.shape[0]) - np.repeat(np.cumsum(rep) - rep, rep)
            c2 = o[np.repeat(gstart[gid], rep) + k]
            tgt = (rvid[c1] // m) * m * m + (rvid[c1] % m) * m + rvid[c2] % m
            perm, starts = _keyed(tgt, n_cl * m * m)
            perm = np.arange(tgt.shape[0]) if perm is None else perm
            plan = _ClusterPlan(
                *(torch.as_tensor(a, dtype=torch.long, device=device) for a in (c1, c2, perm)),
                torch.as_tensor(starts, dtype=torch.int32, device=device), n_cl, m, dr_s,
            )
        info.clusters[m] = plan
    return info.clusters[m]


def check_slice(info: SchurInfo, batches) -> None:
    """Raise ``NotImplementedError`` where the dual-sorted route
    (``w_impl="fused"``) is asked of a problem that does not take it: the
    implicit backend, or a coupling batch that does not qualify
    (:func:`_check_dual_route`)."""
    if info.w_impl != "fused":
        return
    if info.implicit:
        raise NotImplementedError(
            "w_impl='fused' is a route of the direct solve's assembly; this "
            "problem compiled the implicit backend"
        )
    for bi, b in enumerate(batches):
        if len(b.manifolds) > 1 and _elim_slots(b, info):
            _check_dual_route(bi, info.fast[bi], info.generic_why)


def _check_dual_route(bi: int, f, generic_why: str = "") -> None:
    """Raise unless batch ``bi`` qualifies for the dual-sorted route: one
    obs-major bucket and a camera repack within the skew limits."""
    if not isinstance(f, _FastBatch):
        why = f"it is not obs-major ({generic_why or 'the problem takes the generic route'})"
    elif len(f.buckets) != 1:
        why = f"its layout has {len(f.buckets)} degree buckets"
    elif f.cam_batch is None:
        why = "its camera repack passes the skew limits (_FAST_MAX_CAM_K, _OBS_MAJOR_MAX_RATIO)"
    else:
        return
    raise NotImplementedError(
        f"w_impl='fused': cost batch {bi} does not qualify for the dual-sorted "
        f"route, {why}; w_impl='fused_all' takes it"
    )


def _upload_sum(s: Optional[_Sum], device, out_dtype=torch.long):
    """A :class:`_Sum` with its arrays on ``device``."""
    if s is None:
        return None
    out = s.out
    if isinstance(out, np.ndarray):
        out = torch.as_tensor(out, dtype=out_dtype, device=device)
    elif isinstance(out, tuple) and out and isinstance(out[0], np.ndarray):
        out = tuple(torch.as_tensor(o, dtype=torch.long, device=device) for o in out)
    return s._replace(
        perm=None if s.perm is None else torch.as_tensor(s.perm, dtype=torch.long, device=device),
        starts=torch.as_tensor(s.starts, dtype=torch.int32, device=device),
        out=out,
    )


def upload_tables(info: SchurInfo, device, dtype) -> None:
    """Place each batch's tables on the device: an obs-major batch's camera
    columns and camera-order rows, whole (kernel B2's) and, for a uniform
    batch, as ``[K, L]`` views (B1's and B8's, strided like its Jacobian
    tile), kernel B2's work list, its camera runs and its extras, and its
    camera repack as a device batch on the dual-sorted route; the run
    tables (``_RunBatch.keys``) of a landmark-sorted one, with, on the
    direct path, each cost's W column and the kernel rows; for both, each
    camera's reduced rows and the a_rr pair index of the ``ab`` rows
    (upper triangle, row-major); a generic batch's block columns (and its
    coupling keys, implicit); the generic sums' and the implicit solve's
    plans; and kernel B3/B4's or B5's tables of W."""
    if info.w_pairs is not None:
        info.w_pairs = schur_reduce.upload_tables(info.w_pairs, device)
    if info.w_rows is not None:
        info.w_rows = schur_reduce.upload_tables(info.w_rows, device)
    p = info.plan
    if p is not None:
        info.plan = _GenericPlan(
            b=tuple(_upload_sum(s, device) for s in p.b),
            a=tuple(_upload_sum(s, device) for s in p.a),
            l=_upload_sum(p.l, device),
            w=tuple(_upload_sum(s, device, torch.int32) for s in p.w),
            w_inc=p.w_inc,
        )
    if info.cg is not None:
        info.cg = dataclasses.replace(
            info.cg,
            vec=tuple(_upload_sum(s, device) for s in info.cg.vec),
            corr=tuple(_upload_sum(s, device) for s in info.cg.corr),
        )
    for f in info.fast:
        if isinstance(f, _GenBatch):
            f.sel = tuple(None if c is None else torch.as_tensor(c, dtype=torch.long, device=device)
                          for c in (f.sel_r, f.sel_e))
            if info.implicit:
                f.keys = WPart(
                    w_blk=None,
                    rows_r=torch.as_tensor(f.rows_r, dtype=torch.long, device=device),
                    lid=torch.as_tensor(f.lid, dtype=torch.long, device=device),
                    lstarts=torch.as_tensor(f.lstarts, device=device),
                )
            continue
        dr_s = f.dr_s
        if isinstance(f, _FastBatch):
            f.vc_all, f.cpos_all = (
                torch.as_tensor(col, dtype=torch.int32, device=device)
                for col in (f.rvid, f.cam_pos)
            )
            if len(f.buckets) == 1:
                ((_, lb, kb, c0),) = f.buckets
                f.vc, f.cpos = (col[c0 : c0 + lb * kb].view(lb, kb).T
                                for col in (f.vc_all, f.cpos_all))
            if f.slots is not None:
                f.slots = fused_obs.SlotTables(
                    *(torch.as_tensor(t, device=device) for t in f.slots)
                )
            f.cstarts = torch.as_tensor(f.cam_starts, device=device)
            f.ex_idx = torch.as_tensor(f.ex_cols, dtype=torch.long, device=device)
            f.ex_cstarts = torch.as_tensor(f.ex_starts, device=device)
            if f.cam_batch is not None:
                f.cam_batch = engine.device_batch(f.cam_batch, device, dtype)
        else:
            rb = np.concatenate([f.row_base, [info.dim_reduced]])[f.rvid]
            real = f.rvid[:, None] < f.n_r
            f.keys = WPart(
                w_blk=None,
                rows_r=torch.as_tensor(
                    np.where(real, rb[:, None] + np.arange(dr_s), info.dim_reduced),
                    dtype=torch.long, device=device,
                ),
                lid=torch.as_tensor(f.lid, dtype=torch.long, device=device),
                lstarts=torch.as_tensor(f.lstarts, device=device),
                cperm=torch.as_tensor(f.cperm, dtype=torch.long, device=device),
                cstarts=torch.as_tensor(f.cstarts, device=device),
            )
            if not info.implicit:
                f.colbase = torch.as_tensor(
                    np.where(real[:, 0], rb, -1), dtype=torch.int32, device=device
                )
                if f.kernel_rows is not None:
                    f.kr = torch.as_tensor(f.kernel_rows, dtype=torch.long, device=device)
        f.rows = torch.as_tensor(
            np.asarray(f.row_base)[:, None] + np.arange(dr_s), dtype=torch.long, device=device
        )
        f.pair_of = _pair_of(dr_s, device)


def _pair_of(dr_s: int, device):
    """[dr_s²] row of a_rr entry (p, q) among the upper-triangle rows
    (row-major) that the assembly reduces."""
    pi, qi = np.triu_indices(dr_s)
    pair_of = np.zeros((dr_s, dr_s), dtype=np.int64)
    pair_of[pi, qi] = np.arange(len(pi))
    pair_of[qi, pi] = pair_of[pi, qi]
    return torch.as_tensor(pair_of.reshape(-1), device=device)


def _weighted(batch, variables, fast: _FastBatch, dtype):
    """``(cost, jac [n, S, B], g0 [S, B], ρ′·mask, 2ρ″·mask)`` of an
    obs-major batch."""
    cost, _, jac, g0, d1, d2, _ = engine.batch_res_jac_cm(
        batch, variables, runs=(fast.e_slot, fast.buckets)
    )
    mval = batch.mask.to(dtype)
    return cost, jac, g0, d1 * mval, 2.0 * d2 * mval


def _into_args(weighted, info: SchurInfo, fast: _FastBatch, batch):
    cost, jac, g0, d1m, d2m = weighted
    e0 = sum(m.dof for m in batch.manifolds[: fast.e_slot])
    return cost, (jac, g0, d1m, d2m, fast.vc_all, fast.cpos_all, fast.slots), (
        fast.n_r, fast.dr_s, info.dof_elim, e0)


def batch_inputs(batch, variables, info: SchurInfo, fast: _FastBatch, dtype):
    """``(cost, head, tail)``: the batch's masked cost and kernel B2's
    arguments around its buffers — ``head = (jac [n, S, B], g0 [S, B],
    ρ′·mask, 2ρ″·mask, camera columns, camera-order rows, slot tables)``,
    ``tail = (n_r, dr_s, dl, e_start)``."""
    return _into_args(_weighted(batch, variables, fast, dtype), info, fast, batch)


def _tile_args(weighted, info: SchurInfo, fast: _FastBatch, batch):
    if len(fast.buckets) != 1:
        raise ValueError(f"fused_inputs: {len(fast.buckets)} buckets; B1 and B8 take one")
    ((_, lb, kb, c0),) = fast.buckets
    cost, jac, g0, d1m, d2m = weighted
    nres, stot = jac.shape[0], jac.shape[1]
    sl = slice(c0, c0 + lb * kb)
    return cost, (
        jac[:, :, sl].reshape(nres, stot, lb, kb).transpose(2, 3),
        g0[:, sl].reshape(stot, lb, kb).transpose(1, 2),
        d1m[sl].reshape(lb, kb).T,
        d2m[sl].reshape(lb, kb).T,
        fast.vc,
        fast.n_r,
        fast.dr_s,
        info.dof_elim,
        sum(m.dof for m in batch.manifolds[: fast.e_slot]),
    )


def fused_inputs(batch, variables, info: SchurInfo, fast: _FastBatch, dtype):
    """``(cost, args)``: a uniform batch's masked cost and the arguments of
    kernel B8 — the tile ``jac [n, S, K, L]``, ``g0``, ``ρ′·mask``,
    ``2ρ″·mask`` and the camera columns (views of the batch,
    landmark-major in memory), then ``(n_r, dr_s, dl, e_start)``; B1 takes
    the camera-order rows (``fast.cpos``) after the camera columns, and
    the camera runs (``fast.cstarts``)."""
    return _tile_args(_weighted(batch, variables, fast, dtype), info, fast, batch)


def _extras_rows(weighted, fast: _FastBatch, e0: int, dl: int):
    """The camera rows ``[n_ex, npairs + dr_s]`` (a_rr's upper triangle,
    then b_r, as B1 and B2 write theirs) of the extras region's costs, in
    camera order."""
    _, jac, g0, d1m, d2m = weighted
    idx, dr_s = fast.ex_idx, fast.dr_s
    r_rows = _reduced_rows(e0, dl, dr_s, jac.device)
    jr = jac.index_select(2, idx)[:, r_rows]
    gr = g0.index_select(1, idx)[r_rows]
    a1, a2 = d1m[idx], d2m[idx]
    pi, qi = _triu_rows(dr_s, jac.device)
    ha = (jr[:, pi] * jr[:, qi]).sum(0) * a1 + a2 * gr[pi] * gr[qi]
    return torch.cat([ha, gr * a1]).T


def assemble_schur(batches, variables, info: SchurInfo, dtype,
                   assemble_kernel: Callable = fused_obs.fused_obs_all,
                   assemble_into_kernel: Callable = fused_obs.fused_obs_all_into,
                   segment_sum: Callable = segment_block_sum,
                   place_w: Callable = w_place.place_w,
                   assemble_leg: Callable = fused_obs.fused_obs_leg):
    """``(cost, (a_rr, b_r, h_ll, g_l, w))`` for the direct solve.  The
    obs-major batch goes through the whole-system assembly kernels, one
    pass over its obs-major Jacobian: kernel B1 for a single bucket, one
    launch of kernel B2 over every bucket of a degree-bucketed batch, then
    one ``segment_sum`` (kernel B6) over the camera runs of the per-slot
    camera rows that B2 wrote (B1 makes that sum itself), and one more
    over the extras region's camera rows: the system has the same bits on
    every assembly.  On the dual-sorted route (``info.w_impl == "fused"``)
    kernel B8 makes that pass without the camera side, and the
    camera-major leg (:func:`_fast_dual_cam_leg`) sums a_rr and b_r over
    camera runs, extras included.  An adaptive batch goes through
    :func:`_assemble_generic`; every other batch through the generic sums
    (:func:`_add_generic`: B6 over keyed runs, W placed by kernel B7).
    ``batches`` are the compiled device batches; :func:`check_slice` has
    vetted them."""
    dr, L, dl = info.dim_reduced, info.num_elim, info.dof_elim
    dev = next(iter(variables.values())).device
    total = torch.zeros((), dtype=dtype, device=dev)
    a_rr = torch.zeros(dr, dr, dtype=dtype, device=dev)
    b_r = torch.zeros(dr, dtype=dtype, device=dev)
    h_ll = torch.zeros(dl, dl, L, dtype=dtype, device=dev)
    g_l = torch.zeros(dl, L, dtype=dtype, device=dev)
    w, blocks = None, {}
    for bi, (batch, fast) in enumerate(zip(batches, info.fast)):
        if isinstance(fast, _GenBatch):
            cost, *blocks[bi] = _generic_blocks(batch, variables, fast, dl)
            total = total + cost
            continue
        if isinstance(fast, _RunBatch):
            cost, w_b = _assemble_generic(
                batch, variables, info, fast, dtype, segment_sum, place_w,
                a_rr, b_r, h_ll, g_l,
            )
            total = total + cost
            w = w_b if w is None else w + w_b
            continue
        n_r, dr_s = fast.n_r, fast.dr_s
        weighted = _weighted(batch, variables, fast, dtype)
        total = total + weighted[0]
        if fast.slots is not None:
            # B2 adds into h_ll and g_l, writes W's blocks into a zeroed W
            # and each real slot's camera row once.
            _, head, tail = _into_args(weighted, info, fast, batch)
            w_b = torch.zeros(L, dl, n_r * dr_s, dtype=dtype, device=dev)
            rows = torch.empty(int(fast.cam_starts[-1]), dr_s * (dr_s + 3) // 2,
                               dtype=dtype, device=dev)
            assemble_into_kernel(*head, h_ll, g_l, w_b, rows, *tail)
            w = w_b if w is None else w + w_b
            _add_camera_blocks(a_rr, b_r, segment_sum(rows, fast.cstarts), fast.pair_of,
                               fast.rows)
        else:
            _, args = _tile_args(weighted, info, fast, batch)
            if info.w_impl == "fused":
                h_add, g_add, w_b = assemble_leg(*args)
                h_ll += h_add
                g_l += g_add
                w = w_b if w is None else w + w_b
                _fast_dual_cam_leg(fast, variables, info.dof_elim, dtype, a_rr, b_r)
                continue
            h_add, g_add, w_b, ab = assemble_kernel(*args[:5], fast.cpos, fast.cstarts,
                                                    *args[5:])
            h_ll += h_add
            g_l += g_add
            w = w_b if w is None else w + w_b
            _add_camera_blocks(a_rr, b_r, ab, fast.pair_of, fast.rows)
        if fast.ex_cols.shape[0]:
            ex = _extras_rows(weighted, fast, sum(m.dof for m in batch.manifolds[: fast.e_slot]),
                              dl)
            _add_camera_blocks(a_rr, b_r, segment_sum(ex, fast.ex_cstarts), fast.pair_of,
                               fast.rows)
    w_g = _add_generic(blocks, info, segment_sum, place_w, a_rr, b_r, h_ll, g_l)
    if w_g is not None:
        w = w_g if w is None else w + w_g
    if w is None:
        w = torch.zeros(L, dl, dr, dtype=dtype, device=dev)
    return total, (a_rr, b_r, h_ll, g_l, w)


def _generic_blocks(batch, variables, gen: _GenBatch, dl: int):
    """The per-cost blocks of a generic batch (``engine.batch_grad_hess``,
    masked costs zeroed), split as the JAX package splits them: ``(cost,
    g_r [B, Sr], h_rr [B, Sr, Sr], le [B, dl² + dl] or None, h_re [B, Sr,
    dl] or None)``, ``le`` the landmark block and gradient, ``h_re`` the
    coupling block of each cost."""
    cost, g, h = engine.batch_grad_hess(batch, variables)
    m = batch.mask
    g = torch.where(m[:, None], g, torch.zeros_like(g))
    h = torch.where(m[:, None, None], h, torch.zeros_like(h))
    sel_r, sel_e = gen.sel
    h_r = h.index_select(1, sel_r)
    out = (cost, g.index_select(1, sel_r), h_r.index_select(2, sel_r))
    if sel_e is None:
        return (*out, None, None)
    le = torch.cat([h.index_select(1, sel_e).index_select(2, sel_e).reshape(-1, dl * dl),
                    g.index_select(1, sel_e)], 1)
    return (*out, le, h_r.index_select(2, sel_e))


def _gather_rows(s: _Sum, take):
    """The rows of :class:`_Sum` ``s``'s sources (``take(*source)``),
    concatenated and taken in its order."""
    vals = [take(*src) for src in s.sources]
    v = vals[0] if len(vals) == 1 else torch.cat(vals)
    return v if s.perm is None else v.index_select(0, s.perm)


def _add_generic(blocks, info: SchurInfo, segment_sum, place_w, a_rr, b_r, h_ll, g_l):
    """Add the generic batches' blocks (``blocks[batch] = (g_r, h_rr, le,
    h_re)``, :func:`_generic_blocks`) into a_rr, b_r, h_ll and g_l in
    place, each keyed sum of ``info.plan`` through ``segment_sum`` (kernel
    B6); returns their W ``[L, dl, Dr]`` placed by ``place_w`` (kernel B7,
    one launch per slot width), or None."""
    plan = info.plan
    L, dl, dr = info.num_elim, info.dof_elim, info.dim_reduced
    for s in plan.b:
        base, n, dof = s.out
        v = _gather_rows(s, lambda bi, c: blocks[bi][0][:, c : c + dof])
        b_r[base : base + n * dof] += segment_sum(v, s.starts).reshape(-1)
    for s in plan.a:
        ra, rb = s.out
        da, db = ra.shape[1], rb.shape[1]
        v = _gather_rows(s, lambda bi, ca, cb: blocks[bi][1][:, ca : ca + da, cb : cb + db]
                         .reshape(-1, da * db))
        a_rr[ra[:, :, None], rb[:, None, :]] += segment_sum(v, s.starts).view(-1, da, db)
    if plan.l is not None:
        lsum = segment_sum(_gather_rows(plan.l, lambda bi, _: blocks[bi][2]), plan.l.starts)
        h_ll += lsum[:, : dl * dl].T.reshape(dl, dl, L)
        g_l += lsum[:, dl * dl :].T
    w = None
    for s in plan.w:
        v = _gather_rows(s, lambda bi, c, d: blocks[bi][3][:, c : c + d].transpose(1, 2))
        w_d = place_w(v, s.starts, s.out, dr)
        w = w_d if w is None else w + w_d
    return w


def _add_camera_blocks(a_rr, b_r, ab, pair_of, rows):
    """Add the per-camera sums ``ab [n_r, npairs + dr_s]`` (the
    upper-triangle a_rr pairs, then b_r) into a_rr and b_r in place, camera
    v's block at its reduced rows ``rows [n_r, dr_s]``."""
    n_r, dr_s = rows.shape
    npairs = dr_s * (dr_s + 1) // 2
    a_rr[rows[:, :, None], rows[:, None, :]] += ab[:, pair_of].reshape(n_r, dr_s, dr_s)
    b_r[rows] += ab[:, npairs:]


@functools.lru_cache(maxsize=None)
def _reduced_rows(e0: int, dl: int, dr_s: int, device):
    """The Jacobian rows of a cost's reduced (camera) slots, those outside
    the landmark's ``[e0, e0 + dl)``, as a device index: built at the first
    call (on the card, in the graph driver's warm-up), so that no index is
    copied from the host afterwards (a CUDA graph cannot capture that)."""
    rows = [i for i in range(dr_s + dl) if not e0 <= i < e0 + dl]
    return torch.tensor(rows, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _triu_rows(d: int, device):
    """``np.triu_indices(d)`` as two device indices (as
    :func:`_reduced_rows`, built once)."""
    return tuple(torch.as_tensor(i, dtype=torch.long, device=device) for i in np.triu_indices(d))


def _fast_dual_cam_leg(fast: _FastBatch, variables, dl: int, dtype, a_rr, b_r):
    """Camera-major leg of the dual-sorted assembly (the JAX package's
    ``_fast_dual_cam_leg``): the Jacobian evaluated a second time over the
    camera repack, the camera slot gathered once per camera run, then
    a_rr and b_r as plain reshape-sums over the ``[n_r, cam_k]`` runs (the
    cost is not counted again), added in place at each camera's rows."""
    cb, n_r, kc, dr_s = fast.cam_batch, fast.n_r, fast.cam_k, fast.dr_s
    _, _, jac, g0, d1, d2, _ = engine.batch_res_jac_cm(
        cb, variables, runs=(fast.r_slot, ((0, n_r, kc, 0),))
    )
    mval = cb.mask.to(dtype)
    d1m = d1 * mval
    d2m = 2.0 * d2 * mval
    e0 = sum(m.dof for m in cb.manifolds[: fast.e_slot])
    r_rows = _reduced_rows(e0, dl, dr_s, jac.device)
    jr, gr = jac[:, r_rows, : n_r * kc], g0[r_rows, : n_r * kc]
    d1m, d2m = d1m[: n_r * kc], d2m[: n_r * kc]
    ha = torch.einsum("npb,nqb->pqb", jr, jr) * d1m + d2m * gr[:, None] * gr[None]
    a_blocks = ha.reshape(dr_s, dr_s, n_r, kc).sum(-1)
    b_blocks = (gr * d1m).reshape(dr_s, n_r, kc).sum(-1)
    rows = fast.rows
    a_rr[rows[:, :, None], rows[:, None, :]] += a_blocks.permute(2, 0, 1)
    b_r[rows] += b_blocks.T


def _run_blocks(batch, variables, runs: _RunBatch, dl: int, dtype):
    """The per-cost blocks of a landmark-sorted batch, composed per output
    from its raw residual data.  Returns ``(cost, lrows, crows, parts,
    kk)``: ``lrows [B, dl² + dl (+ dl·k)]`` the landmark side (h_ll block,
    g_l, then an adaptive kernel's kernel–point cross), ``crows [Nc,
    npairs + dr_s (+ dr_s·k)]`` the camera side in camera order (a_rr upper
    triangle, b_r, kernel–camera cross), ``parts = (jr, je, gr, ge, d1m,
    d2m)`` for the coupling blocks, and ``kk`` the kernel's own block and
    gradient summed over the batch (None for a fixed kernel).  The kernel
    blocks follow the reference's layout (src/residual.jl:85-107): unhalved,
    the cross terms on the unweighted gradient.  Masked costs contribute
    exactly zero."""
    cost, _, jac, g0, d1, d2, kern = engine.batch_res_jac_cm(batch, variables)
    mval = batch.mask.to(dtype)
    d1m = d1 * mval
    d2m = 2.0 * d2 * mval
    e0, dr_s = runs.e_start, runs.dr_s
    r_rows = _reduced_rows(e0, dl, dr_s, jac.device)
    je, jr = jac[:, e0 : e0 + dl], jac[:, r_rows]  # [n, dl | dr_s, B]
    ge, gr = g0[e0 : e0 + dl], g0[r_rows]
    n_b = jac.shape[-1]
    he = torch.einsum("nab,ncb->acb", je, je) * d1m + d2m * ge[:, None] * ge[None]
    pi, qi = _triu_rows(dr_s, jac.device)
    ha = (jr[:, pi] * jr[:, qi]).sum(0) * d1m + d2m * gr[pi] * gr[qi]
    lcols, ccols, kk = [he.reshape(dl * dl, n_b), ge * d1m], [ha, gr * d1m], None
    if kern is not None:
        dgrad, dhess = kern
        k = dgrad.shape[0] - 1
        dcross = dhess[:k, k] * mval  # [k, B]
        lcols.append((ge[:, None] * dcross[None]).reshape(dl * k, n_b))
        ccols.append((gr[:, None] * dcross[None]).reshape(dr_s * k, n_b))
        kk = ((dhess[:k, :k] * mval).sum(-1), (dgrad[:k] * mval).sum(-1))
    lrows = torch.cat(lcols).T.contiguous()
    crows = torch.cat(ccols).T.index_select(0, runs.keys.cperm)
    return cost, lrows, crows, (jr, je, gr, ge, d1m, d2m), kk


def _assemble_generic(batch, variables, info: SchurInfo, runs: _RunBatch, dtype,
                      segment_sum, place_w, a_rr, b_r, h_ll, g_l):
    """Direct assembly of a landmark-sorted batch whose coupling rows come
    from outside kernels B1/B2 (today the adaptive kernel's three-slot
    batch): the port's counterpart of the standard-layout fall-through of
    the JAX package's ``_assemble_fast_dual``.  h_ll, g_l and the
    kernel–point cross sum over landmark runs and a_rr, b_r and the
    kernel–camera cross over camera runs, each side in one call of
    ``segment_sum`` (kernel B6); ``place_w`` (kernel B7) writes W from the
    per-cost coupling blocks; the kernel's own block is a plain sum.  Adds
    into a_rr, b_r, h_ll and g_l in place; returns ``(cost, W [L, dl,
    Dr])``."""
    L, dl, dr_s = info.num_elim, info.dof_elim, runs.dr_s
    cost, lrows, crows, (jr, je, gr, ge, d1m, d2m), kk = _run_blocks(
        batch, variables, runs, dl, dtype
    )
    lsum = segment_sum(lrows, runs.keys.lstarts)  # [L, dl² + dl (+ dl·k)]
    h_ll += lsum[:, : dl * dl].T.reshape(dl, dl, L)
    g_l += lsum[:, dl * dl : dl * (dl + 1)].T
    csum = segment_sum(crows, runs.keys.cstarts)  # [n_r, npairs + dr_s (+ dr_s·k)]
    cam = dr_s * (dr_s + 3) // 2
    _add_camera_blocks(a_rr, b_r, csum[:, :cam], runs.pair_of, runs.rows)
    # Coupling blocks [B, dl, dr_s], in landmark order; masked ones are zero.
    w_blk = (
        torch.einsum("ndb,npb->bdp", je, jr) * d1m[:, None, None]
        + d2m[:, None, None] * ge.T[:, :, None] * gr.T[:, None, :]
    )
    w = place_w(w_blk, runs.keys.lstarts, runs.colbase, info.dim_reduced)
    if kk is not None and runs.kr is not None:
        kr = runs.kr
        a_kk, g_k = kk
        a_rr[kr[:, None], kr[None, :]] += a_kk
        b_r[kr] += g_k
        cr = csum[:, cam:].reshape(runs.n_r, dr_s, -1)  # [n_r, dr_s, k]
        a_rr[runs.rows[:, :, None], kr] += cr
        a_rr[kr, runs.rows[:, :, None]] += cr
        w[:, :, kr] += lsum[:, dl * (dl + 1) :].reshape(L, dl, -1)
    return cost, w


def assemble_implicit(batches, variables, info: SchurInfo, dtype,
                      segment_sum: Callable = segment_block_sum):
    """``(cost, (a_rr, b_r, h_ll, g_l, wparts))`` for the implicit solve:
    the per-cost blocks of each components-major camera/landmark batch
    (:func:`_run_blocks`) and every keyed sum through ``segment_sum``
    (kernel B6's contract): h_ll and g_l (D = dl² + dl) over the landmark
    runs, the a_rr upper triangle and b_r (D = dr_s(dr_s+1)/2 + dr_s) over
    the camera runs; every other batch's blocks through the generic sums
    (:func:`_add_generic`, without W).  The coupling blocks stay per cost
    in ``wparts``, one per batch with an eliminated slot and reduced
    columns (``info.cg.parts``); no dense W is formed.  ``batches`` are the
    compiled device batches, vetted by :func:`check_slice`."""
    dr, L, dl = info.dim_reduced, info.num_elim, info.dof_elim
    dev = next(iter(variables.values())).device
    total = torch.zeros((), dtype=dtype, device=dev)
    a_rr = torch.zeros(dr, dr, dtype=dtype, device=dev)
    b_r = torch.zeros(dr, dtype=dtype, device=dev)
    h_ll = torch.zeros(dl, dl, L, dtype=dtype, device=dev)
    g_l = torch.zeros(dl, L, dtype=dtype, device=dev)
    wparts, blocks = [], {}
    for bi, (batch, runs) in enumerate(zip(batches, info.fast)):
        if isinstance(runs, _GenBatch):
            cost, *blocks[bi] = _generic_blocks(batch, variables, runs, dl)
            total = total + cost
            if bi in info.cg.parts:
                wparts.append(runs.keys._replace(w_blk=blocks[bi][3]))
            continue
        cost, lrows, crows, (jr, je, gr, ge, d1m, d2m), _ = _run_blocks(
            batch, variables, runs, dl, dtype
        )
        total = total + cost
        lsum = segment_sum(lrows, runs.keys.lstarts)  # [L, dl² + dl]
        h_ll += lsum[:, : dl * dl].T.reshape(dl, dl, L)
        g_l += lsum[:, dl * dl :].T
        ab = segment_sum(crows, runs.keys.cstarts)  # [n_r, npairs + dr_s]
        _add_camera_blocks(a_rr, b_r, ab, runs.pair_of, runs.rows)
        # Coupling blocks, batch-major: masked costs are exactly zero.
        w_blk = (
            torch.einsum("npb,ndb->bpd", jr, je) * d1m[:, None, None]
            + d2m[:, None, None] * gr.T[:, :, None] * ge.T[:, None, :]
        )
        wparts.append(runs.keys._replace(w_blk=w_blk))
    _add_generic(blocks, info, segment_sum, None, a_rr, b_r, h_ll, g_l)
    return total, (a_rr, b_r, h_ll, g_l, tuple(wparts))


class _SchurSystem:
    """``grad`` and ``diag_max`` over ``sys = (a_rr, b_r, h_ll, g_l, _)``,
    shared by both solves: with ``solve``, the protocol the iterators
    use; and the two hooks of the landmark-sharded solves
    (``parallel.schur_shard``), which leave the one-card solve as it is."""

    def _reduce(self, *parts):
        """The sums over every rank of the rank-local partial sums
        ``parts`` (one tensor, or a tuple of them): on one card the parts
        themselves."""
        return parts if len(parts) > 1 else parts[0]

    def _h_damp_extra(self, h_ll):
        """What the damped landmark blocks add besides λI, or None: on one
        card nothing; the sharded solves' identity on pad slots."""
        return None

    def _damped_h(self, h_ll):
        """h_ll with :meth:`_h_damp_extra` added."""
        extra = self._h_damp_extra(h_ll)
        return h_ll if extra is None else h_ll + extra

    def _finalize(self, xr, xl):
        """The full step from the reduced part and the components-major
        [dl, L] landmark part, in the flat variable-major order."""
        return torch.cat([xr, xl.T.reshape(-1)])

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return torch.cat([b_r, g_l.T.reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        d = torch.cat([torch.diagonal(a_rr), torch.diagonal(h_ll, dim1=0, dim2=1).reshape(-1)])
        return d.abs().max()

    @staticmethod
    def damped_inverse(h_ll, lam):
        """(h_ll + λI)⁻¹ components-major, by the closed form computed in
        float64 and returned in h_ll's dtype (``lam`` a float or a 0-d
        tensor: the same bits).  On a float32 BAL problem
        some landmark blocks are singular to working precision (the
        Dubrovnik-class problem at its eighth iteration: eigenvalues ~1e4
        and ~1e-4 against λ ~3e-4), and the float32 determinant rounds to
        zero: an infinite inverse, then a NaN step.  The JAX package forms
        it in float32 and passes that point by rounding luck."""
        eye = torch.eye(h_ll.shape[0], dtype=torch.float64, device=h_ll.device)
        return batched_inv_spd_cm(h_ll.double() + lam * eye[:, :, None]).to(h_ll.dtype)


@dataclasses.dataclass(frozen=True)
class SchurOps(_SchurSystem):
    """The direct solve over ``sys = (a_rr, b_r, h_ll, g_l, w)``, routed by
    what the W is, as the JAX package routes it (``SchurOps._solve``).
    The generic assembly's W (a landmark-sorted batch, the JAX package's
    standard-layout route), which comes with its tables ``pairs``, goes to
    ``reduce_external`` (kernel B5) over inverses formed in float64
    (:meth:`damped_inverse`).  An obs-major W (kernels B1, B2, B8), which
    comes with its tables ``rows``, in float32 with dl ≤ 3 goes to
    ``reduce`` (kernel B3), which forms the damped inverses itself; any
    other obs-major W — every float64 solve — to ``reduce_lm`` (kernel B4)
    over inverses formed in float64."""

    dim_reduced: int
    #: damped reduction: kernel B3's dispatcher, or its plain version.
    reduce: Callable = schur_reduce.reduce_s_damped
    #: reduction over external inverses of an obs-major W: kernel B4's
    #: dispatcher, or its plain version.
    reduce_lm: Callable = schur_reduce.reduce_s_lm
    #: the same over the generic W: kernel B5's dispatcher, or its plain
    #: version.
    reduce_external: Callable = schur_reduce.reduce_s
    #: the tables of the generic W (``SchurInfo.w_pairs``), else None.
    pairs: Any = dataclasses.field(default=None, compare=False)
    #: the tables of an obs-major W (``SchurInfo.w_rows``), else None.
    rows: Any = dataclasses.field(default=None, compare=False)

    def reduced(self, sys, lam):
        """``(S, rhs, h_inv)``: the damped reduced system S = A_rr + λI −
        s_sum, rhs = b_r − rhs_sum, and the landmarks' damped inverses."""
        a_rr, b_r, h_ll, g_l, w = sys
        dl = w.shape[1]
        h_ll = self._damped_h(h_ll)
        if self.pairs is not None:
            h_inv = self.damped_inverse(h_ll, lam)
            s_sum, rhs_sum = self.reduce_external(w, h_inv, g_l, self.pairs)
        elif w.dtype == torch.float32 and dl <= schur_reduce.DAMPED_MAX_DL:
            s_sum, rhs_sum, h_inv = self.reduce(w, h_ll, g_l, lam, self.rows)
        else:
            h_inv = self.damped_inverse(h_ll, lam)
            s_sum, rhs_sum = self.reduce_lm(w, h_inv, g_l, self.rows)
        s_sum, rhs_sum = self._reduce(s_sum, rhs_sum)
        eye = torch.eye(self.dim_reduced, dtype=a_rr.dtype, device=a_rr.device)
        return a_rr + lam * eye - s_sum, b_r - rhs_sum, h_inv

    def back_substitute(self, sys, h_inv, xr):
        """The full step from the reduced one: x_l = H⁻¹ (g_l − Wᵀ x_r)."""
        _, _, _, g_l, w = sys
        L, dl, wc = w.shape
        wx = (w.reshape(L * dl, wc) @ xr).reshape(L, dl).T  # [dl, L]
        xl = torch.einsum("del,el->dl", h_inv, g_l - wx)
        return self._finalize(xr, xl)

    def quad(self, sys, x):
        """xᵀHx of the undamped system (the JAX package's ``quad``), over
        the obs-major W ``[L, dl, wc]``."""
        a_rr, _, h_ll, _, w = sys
        L, dl, wc = w.shape
        xr, xl = x[: self.dim_reduced], x[self.dim_reduced:].reshape(L, dl)
        cross = (w.reshape(L * dl, wc) @ xr) @ xl.reshape(-1)
        return xr @ (a_rr @ xr) + 2.0 * cross + torch.einsum("ld,del,le->", xl, h_ll, xl)

    def leg_ex(self, sys, lam0, lu: bool = False):
        """``(x, gᵀHg, ok)``: the undamped solve H x = g through the
        reduction at ``lam0`` (a zero λ: kernel B3 in float32, the float64
        inverses and B4 otherwise) fused with the gradient's curvature gᵀHg
        (the JAX package's ``solve0_quad_grad``): the back-substitution's
        Wᵀx_r and the curvature's cross term Wᵀb_r in one product over W
        (``Wᵀ·[x_r | b_r]``).  ``ok`` as in :meth:`solve_ex`."""
        a_rr, b_r, h_ll, g_l, w = sys
        s, rhs, h_inv = self.reduced(sys, lam0)
        xr, ok = (lu_solve(s, rhs), None) if lu else cholesky_solve_ex(s, rhs)
        L, dl, wc = w.shape
        wt = (w.reshape(L * dl, wc) @ torch.stack([xr, b_r], dim=1)).reshape(L, dl, 2)
        wt = wt.permute(2, 1, 0)  # [2, dl, L]
        xl = torch.einsum("del,el->dl", h_inv, g_l - wt[0])
        ghg = (
            b_r @ (a_rr @ b_r)
            + 2.0 * (wt[1] * g_l).sum()
            + torch.einsum("dl,del,el->", g_l, h_ll, g_l)
        )
        return torch.cat([xr, xl.T.reshape(-1)]), ghg, ok

    def solve0_quad_grad(self, sys):
        """``(x, gᵀHg)``: :meth:`leg_ex` at λ = 0, LU where the Cholesky
        fails (one host read of its flag)."""
        zero = torch.zeros((), dtype=torch.float64, device=sys[0].device)
        x, ghg, ok = self.leg_ex(sys, zero)
        if not bool(ok):
            x, ghg, _ = self.leg_ex(sys, zero, lu=True)
        return x, ghg

    def solve(self, sys, lam):
        """x with (H + λI) x = g, through the damped reduction (``lam`` a
        float or a 0-d tensor: the same bits); the reduced system by
        :func:`cholesky_solve`, LU where the Cholesky fails."""
        s, rhs, h_inv = self.reduced(sys, lam)
        return self.back_substitute(sys, h_inv, cholesky_solve(s, rhs))

    def solve_ex(self, sys, lam, lu: bool = False):
        """``(x, ok)`` without a host sync: the reduced system by
        :func:`cholesky_solve_ex` (``ok`` its device flag), or with ``lu``
        by :func:`lu_solve` (``ok`` None).  :meth:`solve` gives the
        Cholesky ``x`` where ``ok``, else the LU one."""
        s, rhs, h_inv = self.reduced(sys, lam)
        xr, ok = (lu_solve(s, rhs), None) if lu else cholesky_solve_ex(s, rhs)
        return self.back_substitute(sys, h_inv, xr), ok


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
    mitigations), with its two hooks of the sharded solve (``_reduce``
    around the matvec's, the right-hand side's and the preconditioner's W
    sums, ``_h_damp_extra`` in the damped inverses); with ``cluster`` (a
    :func:`cluster_plan`), cluster-Jacobi in place of Schur-Jacobi.

    ``segment_sum`` is kernel B6's dispatcher or its plain version.
    Every :meth:`solve` appends its PCG iteration count to ``cg_iters``."""

    dim_reduced: int
    num_elim: int
    dof_elim: int
    # Reduced families with unfixed variables, (name, base, n, dof) in
    # tangent order (SchurInfo.fams), and the keyed sums over the coupling
    # parts (SchurInfo.cg, an _ImplicitPlan on the device).
    fams: tuple
    plan: Any
    # Relative PCG residual tolerance; None = 1e-5 in float32, 1e-12 in
    # float64 (a float64 tolerance is out of float32's reach and would
    # run every solve to CG_MAX_ITERS).
    tol: Optional[float] = None
    segment_sum: Callable = segment_block_sum
    cg_iters: list = dataclasses.field(default_factory=list, compare=False)
    # Cluster-Jacobi's tables (:func:`cluster_plan`), or None: Schur-Jacobi.
    cluster: Any = dataclasses.field(default=None, compare=False)

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
        if u is None:
            return v.new_zeros(self.dof_elim, self.num_elim)
        return u.T

    def _family_vector(self, sums, take, like):
        """The ``[Dr]`` vector of the per-variable sums ``sums`` (one
        :class:`_Sum` or None per reduced family) of the rows ``take(part,
        column, dof)``, each family's run of rows in order."""
        parts = []
        for (_, _, n, dof), s in zip(self.fams, sums):
            if s is None:
                parts.append(like.new_zeros(n * dof))
                continue
            v = _gather_rows(s, lambda j, c: take(j, c, dof))
            parts.append(self.segment_sum(v, s.starts).reshape(-1))
        if not parts:
            return like.new_zeros(0)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _w_apply(self, wparts, u):
        """y = Σ_c w_c u[:, l_c] at the cost's reduced rows → [Dr], ``u``
        components-major [dl, L]: the block products per cost, then B6 over
        each reduced family's variable runs (deterministic, unlike a
        scatter-add)."""
        up = torch.cat([u.T, u.new_zeros(1, self.dof_elim)])  # row L: dustbin
        ts = [(wp.w_blk * up[wp.lid][:, None, :]).sum(2) for wp in wparts]  # [B, Sr]
        return self._family_vector(self.plan.vec, lambda j, c, d: ts[j][:, c : c + d], u)

    def quad(self, sys, x):
        """xᵀHx of the undamped system (the JAX package's ``quad``): the
        cross term through :meth:`_w_apply` (kernel B6 over variable runs)."""
        a_rr, _, h_ll, _, wparts = sys
        xr = x[: self.dim_reduced]
        xl = x[self.dim_reduced:].reshape(self.num_elim, self.dof_elim)
        cross = xr @ self._w_apply(wparts, xl.T)
        return xr @ (a_rr @ xr) + 2.0 * cross + torch.einsum("ld,del,le->", xl, h_ll, xl)

    def s_matvec(self, sys, h_inv, lam, v):
        """S v with ``h_inv`` = (h_ll + λI)⁻¹ components-major."""
        a_rr, _, _, _, wparts = sys
        u = torch.einsum("del,el->dl", h_inv, self._wt_apply(wparts, v))
        return a_rr @ v + lam * v - self._reduce(self._w_apply(wparts, u))

    def precond_blocks(self, sys, lam, h_inv):
        """``(blocks, a_blocks, corrected)``, per reduced family: the
        damped Schur-Jacobi blocks (A_rr + λI)[v,v] − Σ_c w_c H⁻¹ w_cᵀ over
        variable v's costs in two-slot coupling parts (B6 over variable
        runs), the A_rr-only blocks (A_rr + λI)[v,v], and whether the
        family took the correction (the JAX package's rule: only two-slot
        parts correct, and a family that none sees keeps its A_rr-only
        blocks)."""
        a_rr, _, _, _, wparts = sys
        dl = self.dof_elim
        hi = torch.cat([h_inv.permute(2, 0, 1), h_inv.new_zeros(1, dl, dl)])
        ms = {}

        def m_of(j, dof):
            if j not in ms:
                wp = wparts[j]
                ms[j] = torch.einsum("bpd,bde,bqe->bpq", wp.w_blk, hi[wp.lid], wp.w_blk)
            return ms[j].reshape(-1, dof * dof)

        blocks, a_blocks, corrected = [], [], []
        for (_, base, n, dof), s in zip(self.fams, self.plan.corr):
            idx = base + torch.arange(n * dof, device=a_rr.device).view(n, dof)
            a_b = (a_rr[idx[:, :, None], idx[:, None, :]]
                   + lam * torch.eye(dof, dtype=a_rr.dtype, device=a_rr.device))
            a_blocks.append(a_b)
            corrected.append(s is not None)
            if s is None:
                blocks.append(a_b)
                continue
            corr = self.segment_sum(_gather_rows(s, lambda j, c: m_of(j, dof)), s.starts)
            blocks.append(a_b - self._reduce(corr).view(n, dof, dof))
        return blocks, a_blocks, corrected

    def precond_inverses(self, sys, lam, h_inv):
        """Inverted preconditioner blocks per family; in a corrected family
        each falls back to its A_rr-only inverse when the corrected one
        comes out non-finite (λ = 0 on gauge-deficient problems)."""
        out = []
        for blocks, a_blocks, corrected in zip(*self.precond_blocks(sys, lam, h_inv)):
            inv = batched_inv_spd(blocks)
            if corrected:
                bad = ~torch.isfinite(inv).flatten(1).all(1)
                inv = torch.where(bad[:, None, None], batched_inv_spd(a_blocks), inv)
            out.append(inv)
        return tuple(out)

    def cluster_inverses(self, sys, lam, h_inv):
        """Inverted ``[n_cl, cdim, cdim]`` diagonal cluster blocks of the
        damped S (the JAX package's ``cluster_inverses``): S_CC = (A_rr +
        λI)_CC − Σ_l U_lC H_l⁻¹ U_lCᵀ, each in-cluster pair of one
        landmark's costs giving w_c1 H_l⁻¹ w_c2ᵀ, summed per target by
        kernel B6.  The pad rows of a partial last cluster hold the
        identity; a block that comes out non-finite falls back to its
        A-only inverse."""
        c = self.cluster
        a_rr, _, _, _, wparts = sys
        (wp,) = wparts
        n_cl, m, dof = c.n_cl, c.m, c.dof
        cdim, dr = m * dof, self.dim_reduced
        hw = torch.einsum("bpd,deb->bpe", wp.w_blk, h_inv[:, :, wp.lid.clamp(max=self.num_elim - 1)])
        prod = torch.einsum("xpe,xqe->xpq", hw.index_select(0, c.c1), wp.w_blk.index_select(0, c.c2))
        corr = self.segment_sum(prod.reshape(-1, dof * dof).index_select(0, c.perm), c.starts)
        corr = self._reduce(corr).view(n_cl, m, m, dof, dof).permute(0, 1, 3, 2, 4).reshape(n_cl, cdim, cdim)
        total = n_cl * cdim
        ap = torch.nn.functional.pad(a_rr, (0, total - dr, 0, total - dr))
        if total > dr:
            ap[dr:, dr:] += torch.eye(total - dr, dtype=ap.dtype, device=ap.device)
        eye = torch.eye(cdim, dtype=ap.dtype, device=ap.device)
        a_blocks = torch.diagonal(ap.view(n_cl, cdim, n_cl, cdim), dim1=0, dim2=2)
        a_blocks = a_blocks.permute(2, 0, 1) + lam * eye
        inv = batched_inv_spd(a_blocks - corr)
        bad = ~torch.isfinite(inv).flatten(1).all(1)
        return torch.where(bad[:, None, None], batched_inv_spd(a_blocks), inv)

    def pcg_setup(self, sys, lam):
        """The PCG's set-up at ``lam`` (a float or a 0-d tensor):
        ``(h_inv, inv, tol2, state)`` with the damped inverses, the
        preconditioner's inverted blocks, the squared absolute tolerance
        and the start ``state = (x, r, z, p, rz, k)``, each a tensor of its
        own (:meth:`pcg_chunk` may update them in place)."""
        _, b_r, h_ll, g_l, wparts = sys
        h_inv = self.damped_inverse(self._damped_h(h_ll), lam)
        rhs = b_r - self._reduce(self._w_apply(wparts, torch.einsum("del,el->dl", h_inv, g_l)))
        if self.cluster is not None:
            inv = (self.cluster_inverses(sys, lam, h_inv),)
        else:
            inv = self.precond_inverses(sys, lam, h_inv)
        tol2, state = pcg_start(rhs, functools.partial(self._precond, inv), self._tol(rhs.dtype))
        return h_inv, inv, tol2, state

    def _precond(self, inv, r):
        """The block-Jacobi apply, family by family over their row runs;
        with cluster-Jacobi, cluster by cluster (contiguous rows, the last
        cluster padded)."""
        if self.cluster is not None:
            (cinv,) = inv
            n_cl, cdim = cinv.shape[0], cinv.shape[1]
            rp = torch.cat([r, r.new_zeros(n_cl * cdim - r.shape[0])])
            z = torch.einsum("nxy,ny->nx", cinv, rp.view(n_cl, cdim))
            return z.reshape(-1)[: r.shape[0]]
        parts = [
            torch.einsum("nst,nt->ns", i, r[base : base + n * dof].view(n, dof)).reshape(-1)
            for (_, base, n, dof), i in zip(self.fams, inv)
        ]
        if not parts:
            return r.new_zeros(0)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def pcg_chunk(self, sys, lam, h_inv, inv, tol2, state):
        """``linearsolver.CG_CHECK_EVERY`` PCG iterations from ``state``
        (:func:`linearsolver.pcg_chunk` over :meth:`s_matvec`), capped at
        :data:`CG_MAX_ITERS`.  Returns the new state and ``flag = [more,
        iterations]`` in the system's dtype, still on the device."""
        return pcg_chunk(functools.partial(self.s_matvec, sys, h_inv, lam),
                         functools.partial(self._precond, inv), tol2, state, CG_MAX_ITERS)

    def pcg_finish(self, sys, h_inv, state):
        """The step from the PCG's reduced solution: the landmark
        back-substitution."""
        _, _, _, g_l, wparts = sys
        x = state[0]
        xl = torch.einsum("del,el->dl", h_inv, g_l - self._wt_apply(wparts, x))
        return self._finalize(x, xl)

    def solve(self, sys, lam):
        """x with (H + λI) x = g: PCG on the reduced system, then the
        landmark back-substitution (:meth:`pcg_setup`, :meth:`pcg_chunk`
        until converged, :meth:`pcg_finish`); the host reads the
        convergence flag and the iteration count after every chunk."""
        h_inv, inv, tol2, state = self.pcg_setup(sys, lam)
        more = True
        while more:
            state, flag = self.pcg_chunk(sys, lam, h_inv, inv, tol2, state)
            more, iters = flag.tolist()
        self.cg_iters.append(int(iters))
        return self.pcg_finish(sys, h_inv, state)
