"""Landmark-sharded Schur solves, direct and implicit, across the ranks of
a process group (port of ``nllstpu/parallel/schur_shard.py``).

The data-parallel path (:mod:`.mesh`) sums the whole system, W included,
on every rank.  Here every landmark has one owning rank, and every cost
goes to the rank that owns its landmark:

* each rank assembles and keeps a complete LOCAL ``h_ll``, ``g_l`` and W
  for its ``Lc`` landmark slots, never communicated; only the cost,
  ``a_rr`` and ``b_r`` are summed over the ranks;
* the direct solve reduces the local W through the port's own dispatch
  (``SchurOps.reduced``: kernel B3 in float32, kernel B4 over float64
  inverses, kernel B5 over a generic W) and sums only the ``[Dr, Dr]``
  partial Schur correction and the ``[Dr]`` partial right-hand side; the
  reduced Cholesky (LU where it fails) runs replicated, the landmarks'
  back-substitution locally, and the step's landmark part is gathered;
* the implicit solve runs the PCG replicated, and sums each matvec's,
  the right-hand side's and the preconditioner's W terms, every rank's
  kernel B6 sums over its own coupling blocks (``SchurCGOps``' hooks).

Per-rank W memory and elimination work both fall as 1/n.

The JAX package runs every device in one ``shard_map`` program; the port
runs one process per rank (:mod:`.distributed`).  Every rank builds the
same problem, lays out the global structure on the host, routes the rows
as the JAX package does (:func:`shard_plan`: contiguous ownership and
run-preserving positional routing for a uniform obs-major layout, strided
ownership for a degree-bucketed one, routing by the owning landmark for
every other batch), compiles and uploads only its own shard with the
port's table builders, and runs the same host loop (the stepped driver's,
``core.optimize.run_loop``).  Every control decision reads values that an
``all_reduce`` left the same on every rank (the cost, λ's trial scalars,
the Cholesky's flag, the PCG's flag), so the ranks take the same branches
and end with the same bits.  Landmark slots past the real ``L`` (``n·Lc >
L``) hold zero blocks and get the identity before inversion, so a λ = 0
step stays finite and exactly zero there.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, Optional

import numpy as np
import torch

from ..core import engine, iterators, optimize
from ..core.linearsolver import cholesky_solve_ex, lu_solve
from ..core.structs import Options, Result
from ..ops import _build, schur
from .mesh import Mesh, _host_batch

def _bucket_shard_plan(buckets, L, n):
    """Strided decomposition of a bucketed obs-major layout (the JAX
    package's): landmark ``l`` belongs to rank ``l % n``, so that every
    rank gets ``ceil(L_b/n)`` landmarks of every degree class and each
    landmark's ``k_b``-long run stays whole.  The local numbering is the
    same on every rank: ``localid(l) = class_base_loc + (l − l0) // n``;
    the chunk buckets (heavy-prefix overlays, ``l_base == 0``) reuse the
    head class's local base.  Relies on the plan's order: chunk buckets
    first, then the classes in ascending ``l_base``.

    Returns ``(local_buckets, local_extra_base, Lc, gid_table [n, Lc],
    gid_pos [n·Lc], localid [L], owner [L])``: ``gid_table[s, t]`` is the
    global landmark of rank s's slot t (``L``: a pad slot), ``gid_pos``
    reorders the rank-major gathered landmark rows into global order (pad
    landmarks point at a zero pad slot)."""
    i0 = max(i for i, b in enumerate(buckets) if b[0] == 0)
    classes = buckets[i0:]
    assert classes[0][0] == 0
    class_base_loc = {}
    lc = 0
    for (l0, lb, kb, c0) in classes:
        class_base_loc[l0] = lc
        lc += -(-lb // n)
    local_buckets = []
    col = 0
    for (l0, lb, kb, c0) in buckets:  # the plan's order (chunks first)
        lb_loc = -(-lb // n)
        local_buckets.append((class_base_loc[l0], lb_loc, kb, col))
        col += lb_loc * kb
    localid = np.zeros(max(L, 1), dtype=np.int32)
    for (l0, lb, kb, c0) in classes:
        ids = np.arange(l0, l0 + lb)
        localid[ids] = class_base_loc[l0] + (ids - l0) // n
    owner = (np.arange(max(L, 1)) % n).astype(np.int32)
    gid_table = np.full((n, lc), L, dtype=np.int32)
    ls = np.arange(L)
    gid_table[owner[:L], localid[:L]] = ls
    gid_pos = np.empty(n * lc, dtype=np.int64)
    gid_pos[ls] = owner[:L].astype(np.int64) * lc + localid[:L]
    pad_flats = np.nonzero(gid_table.reshape(-1) >= L)[0]
    if L < n * lc:
        gid_pos[L:] = pad_flats[0]  # any zero pad slot
    return tuple(local_buckets), col, lc, gid_table, gid_pos, localid, owner


def _bucket_shard_sels(buckets, n):
    """Per-rank row selections (−1: an in-place pad row) of the strided
    layout: rank s's local block of bucket ``(l0, lb, kb, c0)`` holds the
    runs of landmarks ``l0 + ((s − l0) % n) + t·n``; slots past the class's
    end are pad rows.  The fixed-landmark extras are added after them by
    :func:`_balanced_fill`."""
    sels = []
    for s in range(n):
        parts = []
        for (l0, lb, kb, c0) in buckets:
            lb_loc = -(-lb // n)
            j0 = (s - l0) % n
            g = l0 + j0 + np.arange(lb_loc, dtype=np.int64) * n
            valid = g < l0 + lb
            starts = c0 + (g - l0) * kb
            rows = starts[:, None] + np.arange(kb, dtype=np.int64)[None, :]
            parts.append(np.where(valid[:, None], rows, -1).reshape(-1))
        sels.append(np.concatenate(parts) if parts else np.empty(0, np.int64))
    return sels


def _balanced_fill(counts, n, total_extra):
    """Rank of each of ``total_extra`` extra rows, the emptiest rank
    first."""
    counts = list(counts)
    out = np.empty(total_extra, dtype=np.int64)
    for i in range(total_extra):
        s = int(np.argmin(counts))
        out[i] = s
        counts[s] += 1
    return out


def _slice_batch(batch, sel, mask_np):
    """A rank's host shard: rows ``sel`` of ``batch`` padded to a multiple
    of 8 rows (pad rows repeat row 0 with mask False).  Entries of ``sel``
    equal to −1 are in-place pad rows, which keep every rank's landmark-run
    region exactly ``Lc·k`` rows long under the positional routing.  The
    JAX package pads every rank to the longest rank's rows (one SPMD
    program); each rank here keeps its own length."""
    sel = np.asarray(sel, dtype=np.int64)
    target = -(-max(1, len(sel)) // 8) * 8
    safe = np.where(sel < 0, 0, sel)
    rows = np.concatenate([safe, np.zeros(target - len(sel), dtype=np.int64)])
    mask = np.concatenate([np.where(sel < 0, False, mask_np[safe]),
                           np.zeros(target - len(sel), dtype=bool)])
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i)[rows] for i in batch.idx),
        params=None if batch.params is None else np.asarray(batch.params)[rows],
        mask=mask,
        n=int(mask.sum()),
        take=rows if batch.take is None else np.asarray(batch.take)[rows],
    )


@dataclasses.dataclass
class ShardPlan:
    """The host plan of a landmark-sharded solve over ``n`` ranks, the same
    as the JAX package's ``parallelize_schur`` builds: ``num_elim`` (L)
    real landmarks in ``num_elim_local`` (Lc) slots per rank; ``elim_ids``
    ``[n, n_vars]``, each eliminated variable's local slot on its owning
    rank (``Lc`` elsewhere); ``gid_table``/``gid_pos``, the strided
    ownership maps of a bucketed layout (:func:`_bucket_shard_plan`; None
    under contiguous ownership: rank s owns landmarks ``[s·Lc, (s+1)·Lc)``);
    per batch, each rank's row selection (``sels``, −1 an in-place pad
    row) and the local bucket plan of the obs-major batch (``buckets``,
    else None); ``route`` that batch."""

    n: int
    num_elim: int
    num_elim_local: int
    elim_ids: np.ndarray
    gid_table: Optional[np.ndarray]
    gid_pos: Optional[np.ndarray]
    route: Optional[int]
    sels: list
    buckets: list

    def gids(self, s: int) -> np.ndarray:
        """The global landmark of each of rank s's slots (L: a pad slot)."""
        if self.gid_table is not None:
            return self.gid_table[s].astype(np.int64)
        g = s * self.num_elim_local + np.arange(self.num_elim_local)
        return np.minimum(g, self.num_elim)

    def shard(self, batches, bi: int, s: int):
        """Rank s's host shard of batch ``bi``."""
        b = batches[bi]
        return _slice_batch(b, self.sels[bi][s], np.asarray(b.mask))


def shard_plan(info: schur.SchurInfo, batches, buckets, route, n: int) -> ShardPlan:
    """The :class:`ShardPlan` of host ``batches`` over ``n`` ranks, as
    ``core.optimize.schur_routes`` lays them out (``info`` the global split,
    ``buckets`` per batch and ``route`` the obs-major batch, None on the
    implicit solve): strided ownership where the obs-major batch is
    degree-bucketed, contiguous ownership otherwise; the obs-major batch
    routed by position (its landmark runs kept whole, uniform or per
    bucket), every other batch by the rank that owns each cost's landmark;
    the costs on no landmark (fixed landmarks, riders without one, masked
    rows) spread by :func:`_balanced_fill`."""
    L = info.num_elim
    elim_fam = info.elim_family
    gids = np.asarray(info.elim_ids[elim_fam])  # [n_vars] global landmark (L: fixed)
    g_buckets = None if route is None else buckets[route]
    bucket_plan = None
    if g_buckets is not None and len(g_buckets) > 1 and L > 0:
        bucket_plan = _bucket_shard_plan(g_buckets, L, n)
    if bucket_plan is not None:
        local_buckets, _, lc, gid_table, gid_pos, localid, owner = bucket_plan
        real = gids < L
        safe = np.where(real, gids, 0)
        elim_ids = np.full((n, gids.shape[0]), lc, dtype=np.int32)
        for s in range(n):
            owned = real & (owner[safe] == s)
            elim_ids[s, owned] = localid[gids[owned]]
    else:
        lc = -(-max(L, 1) // n)
        gid_table = gid_pos = None
        elim_ids = np.full((n, gids.shape[0]), lc, dtype=np.int32)
        for s in range(n):
            owned = (gids >= s * lc) & (gids < min((s + 1) * lc, L))
            elim_ids[s, owned] = gids[owned] - s * lc
    all_sels, local_plans = [], []
    for bi, b in enumerate(batches):
        mask_np = np.asarray(b.mask)
        elim_slots = schur._elim_slots(b, info)
        rows = np.arange(mask_np.shape[0], dtype=np.int64)
        local = None
        if bi == route and bucket_plan is not None:
            # Each rank takes its strided landmarks' runs per bucket.
            sels = _bucket_shard_sels(g_buckets, n)
            extra_rows = rows[rows >= sum(lb * kb for (_, lb, kb, _) in g_buckets)]
            local = local_buckets
        elif bi == route:
            # Positional routing of a uniform obs-major batch: rank s takes
            # the contiguous rows of its landmarks' runs (masked slots
            # inside them too), so that its shard is obs-major with the same
            # run length; a rank short of Lc landmarks gets in-place pad
            # rows, so its run region is exactly Lc·k rows.
            ((_, _, kk, _),) = g_buckets
            run_l = rows // kk
            sels = []
            for s in range(n):
                lo, hi = s * lc, min((s + 1) * lc, L)
                run_rows = rows[(rows < L * kk) & (run_l >= lo) & (run_l < hi)]
                pad = np.full(max(lc - max(hi - lo, 0), 0) * kk, -1, dtype=np.int64)
                sels.append(np.concatenate([run_rows, pad]))
            extra_rows = rows[rows >= L * kk]
            local = ((0, lc, kk, 0),)
        else:
            if elim_slots:
                lid = gids[np.asarray(b.idx[elim_slots[0]])]
                lid = np.where(mask_np, lid, L)
                if bucket_plan is not None:
                    sh = np.where(lid < L, owner[np.where(lid < L, lid, 0)], -1)
                else:
                    sh = np.where(lid < L, lid // lc, -1)
            else:
                sh = np.full(mask_np.shape[0], -1, dtype=np.int64)
            sels = [np.nonzero(sh == s)[0] for s in range(n)]
            extra_rows = np.nonzero(sh < 0)[0]
        fill = _balanced_fill([len(s) for s in sels], n, len(extra_rows))
        all_sels.append([np.concatenate([sels[s], extra_rows[fill == s]]) for s in range(n)])
        local_plans.append(local)
    return ShardPlan(n=n, num_elim=L, num_elim_local=lc, elim_ids=elim_ids,
                     gid_table=gid_table, gid_pos=gid_pos, route=route, sels=all_sels,
                     buckets=local_plans)


def _compile_rank(plan: ShardPlan, info, layout, batches, manifolds, dtype, device, kernels,
                  rank: int) -> optimize.CompiledProblem:
    """Rank ``rank``'s shard as a compiled problem in its LOCAL landmark
    numbering (``num_elim = Lc``): the obs-major batch keeps its runs
    (kernel B1's tables over one bucket, B2's over the local bucket plan),
    every other batch is sorted by local landmark, and the port's own table
    builders (``schur.fill_tables``: ``_fast_batch_data``, ``w_structure``
    or the implicit plan) and ``schur.upload_tables`` make its tables."""
    local = schur.SchurInfo(
        elim_family=info.elim_family, dim_reduced=info.dim_reduced,
        num_elim=plan.num_elim_local, dof_elim=info.dof_elim,
        elim_ids={info.elim_family: plan.elim_ids[rank]}, implicit=info.implicit,
        fams=info.fams,
    )
    shards = [plan.shard(batches, bi, rank) for bi in range(len(batches))]
    shards = [b if bi == plan.route else schur.sort_for_implicit(b, local)
              for bi, b in enumerate(shards)]
    schur.fill_tables(local, layout, shards, plan.buckets, plan.route)
    schur.upload_tables(local, device, dtype)
    return optimize.CompiledProblem(
        manifolds=manifolds, layout=layout,
        batches=[engine.device_batch(b, device, dtype) for b in shards], dtype=dtype,
        device=device, schur_info=local, kernels=kernels,
    )


class _ShardedSystem:
    """What both sharded solves add to the one-card ones: the hooks (sums
    over the ranks, the identity on pad slots), the gathered landmark step
    and gradient, the rank's slice of a global step, and ``diag_max`` over
    every rank.  Fields: ``mesh``, ``n_global`` (L), ``gids`` (device
    long ``[Lc]``: the global landmark of each local slot, L for a pad),
    ``gid_pos`` (strided ownership's reorder, device long ``[n·Lc]``, or
    None) and ``pad_eye`` (``[dl, dl, Lc]`` identity on pad slots, or
    None)."""

    def _reduce(self, *parts):
        return self.mesh.all_reduce(*parts)

    def _h_damp_extra(self, h_ll):
        return self.pad_eye

    def _gather(self, v, *scalars):
        """The global landmark-major ``[L·dl]`` vector from every rank's
        components-major ``[dl, Lc]`` chunk, placed into zeros at the rank's
        offset and summed over the ranks (adding zeros is exact; the JAX
        package's ``_gather_elim_chunks``), then in global landmark order;
        with ``scalars``, their sums over the ranks too, in the same
        collective."""
        dl, lc = v.shape
        n, r = self.mesh.size, self.mesh.rank
        full = v.new_zeros(n * lc * dl + len(scalars))
        full[r * lc * dl : (r + 1) * lc * dl] = v.T.reshape(-1)
        if scalars:
            full[n * lc * dl :] = torch.stack(scalars)
        full = self.mesh.all_reduce(full)
        x = full[: n * lc * dl].view(n * lc, dl)
        if self.gid_pos is not None:
            x = x.index_select(0, self.gid_pos)
        x = x[: self.n_global].reshape(-1)
        return (x, *full[n * lc * dl :]) if scalars else x

    def _local_x(self, x):
        """This rank's ``[Lc, dl]`` rows of the global step's landmark part
        (zero on pad slots)."""
        xe = x[self.dim_reduced:].reshape(self.n_global, self.dof_elim)
        return torch.cat([xe, xe.new_zeros(1, self.dof_elim)]).index_select(0, self.gids)

    def _finalize(self, xr, xl):
        return torch.cat([xr, self._gather(xl)])

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return torch.cat([b_r, self._gather(g_l)])

    def diag_max(self, sys):
        # Pad slots' h_ll blocks are zero and cannot win the maximum.
        return self.mesh.all_reduce(super().diag_max(sys), op="max")


@dataclasses.dataclass(frozen=True)
class ShardedSchurOps(_ShardedSystem, schur.SchurOps):
    """The direct solve's protocol (``SchurOps``: ``reduced``,
    ``back_substitute``, ``quad``, ``leg_ex``, ``solve0_quad_grad``,
    ``solve``, ``solve_ex``, ``grad``, ``diag_max``) over a landmark-sharded
    ``sys = (a_rr, b_r, h_ll, g_l, w)``: ``a_rr`` and ``b_r`` replicated,
    ``h_ll [dl, dl, Lc]``, ``g_l [dl, Lc]`` and ``w [Lc, dl, Dr]`` this
    rank's.  ``reduced`` reduces the local W through ``SchurOps``' own
    dispatch (``rows``/``pairs``: the rank's tables), sums ``(s_sum,
    rhs_sum)`` over the ranks and forms ``a_rr + λI − s_sum`` once; the
    solve is replicated, the back-substitution local, its landmark part
    gathered.  Steps and gradients are the global ``[Dr + L·dl]``
    vectors."""

    mesh: Any = dataclasses.field(default=None, compare=False)
    n_global: int = 0
    dof_elim: int = 0
    gids: Any = dataclasses.field(default=None, compare=False)
    gid_pos: Any = dataclasses.field(default=None, compare=False)
    pad_eye: Any = dataclasses.field(default=None, compare=False)

    def quad(self, sys, x):
        a_rr, _, h_ll, _, w = sys
        lc, dl, wc = w.shape
        xr, xl = x[: self.dim_reduced], self._local_x(x)
        cross = (w.reshape(lc * dl, wc) @ xr) @ xl.reshape(-1)
        local = 2.0 * cross + torch.einsum("ld,del,le->", xl, h_ll, xl)
        return xr @ (a_rr @ xr) + self._reduce(local)

    def leg_ex(self, sys, lam0, lu: bool = False):
        """``SchurOps.leg_ex`` with the local terms of gᵀHg summed over the
        ranks in the collective that gathers the landmark step."""
        a_rr, b_r, h_ll, g_l, w = sys
        s, rhs, h_inv = self.reduced(sys, lam0)
        xr, ok = (lu_solve(s, rhs), None) if lu else cholesky_solve_ex(s, rhs)
        lc, dl, wc = w.shape
        wt = (w.reshape(lc * dl, wc) @ torch.stack([xr, b_r], dim=1)).reshape(lc, dl, 2)
        wt = wt.permute(2, 1, 0)  # [2, dl, Lc]
        xl = torch.einsum("del,el->dl", h_inv, g_l - wt[0])
        local = 2.0 * (wt[1] * g_l).sum() + torch.einsum("dl,del,el->", g_l, h_ll, g_l)
        x_l, ghg = self._gather(xl, local)
        return torch.cat([xr, x_l]), b_r @ (a_rr @ b_r) + ghg, ok


@dataclasses.dataclass(frozen=True)
class ShardedSchurCGOps(_ShardedSystem, schur.SchurCGOps):
    """The implicit solve over a landmark-sharded ``sys = (a_rr, b_r,
    h_ll, g_l, wparts)`` (``num_elim`` is the local ``Lc``): the PCG runs
    replicated, and every W term of its matvec, right-hand side and
    Schur-Jacobi preconditioner sums this rank's coupling blocks (kernel
    B6) and then the ranks' sums (``SchurCGOps``' ``_reduce`` hook), so
    that the coupling's memory and work per rank fall as 1/n.
    Cluster-Jacobi is not taken here, as in the JAX package's sharded
    solve."""

    mesh: Any = dataclasses.field(default=None, compare=False)
    n_global: int = 0
    gids: Any = dataclasses.field(default=None, compare=False)
    gid_pos: Any = dataclasses.field(default=None, compare=False)
    pad_eye: Any = dataclasses.field(default=None, compare=False)

    def quad(self, sys, x):
        a_rr, _, h_ll, _, wparts = sys
        xr, xl = x[: self.dim_reduced], self._local_x(x)
        cross = xr @ self._w_apply(wparts, xl.T)
        local = 2.0 * cross + torch.einsum("ld,del,le->", xl, h_ll, xl)
        return xr @ (a_rr @ xr) + self._reduce(local)


@dataclasses.dataclass
class ShardedSchurCompiled:
    """Landmark-sharded execution of a Schur problem on this rank: ``info``
    the global split (no tables: each rank builds its own), ``local`` this
    rank's shard compiled in its local landmark numbering (its batches,
    tables and kernels), ``plan`` the host plan of every rank
    (:func:`shard_plan`)."""

    info: schur.SchurInfo
    mesh: Mesh
    plan: ShardPlan
    local: optimize.CompiledProblem

    def __post_init__(self):
        p, dev = self.plan, self.local.device
        gids = p.gids(self.mesh.rank)
        self._gids = torch.as_tensor(gids, dtype=torch.long, device=dev)
        self._gid_pos = (None if p.gid_pos is None
                         else torch.as_tensor(p.gid_pos, dtype=torch.long, device=dev))
        pad = gids >= p.num_elim
        self._pad_eye = None
        if pad.any():
            eye = torch.eye(self.info.dof_elim, dtype=self.dtype, device=dev)
            self._pad_eye = eye[:, :, None] * torch.as_tensor(pad, dtype=self.dtype, device=dev)

    @property
    def num_elim(self) -> int:
        return self.plan.num_elim

    @property
    def num_elim_local(self) -> int:
        return self.plan.num_elim_local

    @property
    def n_devices(self) -> int:
        return self.plan.n

    @property
    def gid_table(self):
        return self.plan.gid_table

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def ops(self, options: Options = None):
        """This rank's linear-system ops: :class:`ShardedSchurCGOps` on the
        implicit backend (``options.linear_tol`` its PCG tolerance), else
        :class:`ShardedSchurOps`."""
        loc, k = self.local.schur_info, self.local.kernels
        shared = dict(mesh=self.mesh, n_global=self.num_elim, gids=self._gids,
                      gid_pos=self._gid_pos, pad_eye=self._pad_eye)
        if loc.implicit:
            return ShardedSchurCGOps(
                loc.dim_reduced, loc.num_elim, loc.dof_elim, loc.fams, loc.cg,
                tol=None if options is None else options.linear_tol,
                segment_sum=k.segment_sum, **shared,
            )
        return ShardedSchurOps(
            loc.dim_reduced, reduce=k.reduce, reduce_lm=k.reduce_lm,
            reduce_external=k.reduce_external, pairs=loc.w_pairs, rows=loc.w_rows,
            dof_elim=loc.dof_elim, **shared,
        )

    def cost(self, variables):
        """The total cost: this rank's costs, summed over the ranks."""
        return self.mesh.all_reduce(self.local.cost(variables))

    def _assemble(self, variables):
        c, (a_rr, b_r, h_ll, g_l, w) = self.local.assemble(variables)
        c, a_rr, b_r = self.mesh.all_reduce(c, a_rr, b_r)
        return c, (a_rr, b_r, h_ll, g_l, w)

    def assemble(self, variables):
        """``(cost, (a_rr, b_r, h_ll, g_l, w))`` of the direct system: the
        cost, ``a_rr`` and ``b_r`` summed over the ranks (one collective),
        ``h_ll [dl, dl, Lc]``, ``g_l [dl, Lc]`` and ``w [Lc, dl, Dr]`` this
        rank's.  The implicit system's coupling blocks are this rank's by
        construction: drive it with :meth:`solve_once` or :meth:`run`."""
        if self.info.implicit:
            raise ValueError(
                "assemble() is not exposed for the implicit sharded system; "
                "use solve_once()/run()"
            )
        return self._assemble(variables)

    def apply(self, variables, x):
        return self.local.apply(variables, x)

    def solve_once(self, variables, lam):
        """Assemble and solve the damped system once: ``(cost, x)``, x the
        global step (replicated)."""
        c, sys = self._assemble(variables)
        return c, self.ops().solve(sys, lam)

    def ctx(self, options: Options = None, phase=None) -> iterators.IterCtx:
        """The iterators' context over the sharded system: the summed cost,
        this rank's ``apply`` and :meth:`ops`."""
        return iterators.IterCtx(cost=self.cost, apply=self.apply, dtype=self.dtype,
                                 linops=self.ops(options), phase=phase or iterators._no_phase)

    def run(self, vars0, opts: Options) -> dict:
        """The optimization from ``vars0`` (``core.optimize.run_loop`` over
        the sharded system through the stepped driver: phase times fenced),
        the same on every rank; returns its final state (``cg_iters``: the
        implicit solve's PCG iterations per damped solve).  Nothing is
        compiled per ``Options``: the ops are built for each call."""
        loop = types.SimpleNamespace(device=self.device, assemble=self._assemble,
                                     cost=self.cost, ctx=self.ctx)
        return optimize.run_stepped(loop, opts, vars0)


def _shard(info, layout, batches, buckets, route, manifolds, dtype, device, kernels, mesh):
    if device != mesh.device:
        raise ValueError(f"the problem lives on {device}, this rank's mesh on {mesh.device}")
    plan = shard_plan(info, batches, buckets, route, mesh.size)
    local = _compile_rank(plan, info, layout, batches, manifolds, dtype, device, kernels,
                          mesh.rank)
    if info.implicit:
        # Which families the preconditioner corrects follows from the
        # batches' slots, the same on every rank; a rank that differed
        # would skip a collective that the others make, so every rank
        # compares its pattern with the others' (max and min in one
        # collective) and all raise together.
        mine = torch.tensor([s is not None for s in local.schur_info.cg.corr],
                            dtype=torch.float32, device=device)
        hi, neg_lo = mesh.all_reduce(mine, -mine, op="max")
        if not torch.equal(hi, -neg_lo):
            raise AssertionError("the ranks' implicit plans correct different families")
    return ShardedSchurCompiled(info=info, mesh=mesh, plan=plan, local=local)


def parallelize_schur(compiled: optimize.CompiledProblem, mesh: Mesh) -> ShardedSchurCompiled:
    """Partition a Schur compiled problem (direct or implicit) across
    ``mesh``'s ranks by landmark ownership (see the module docstring); this
    rank compiles and uploads its own shard."""
    info = compiled.schur_info
    if info is None:
        raise ValueError(
            "parallelize_schur requires a Schur compiled problem "
            "(solver='schur' or 'schur_cg'); use parallel.mesh.parallelize "
            "otherwise"
        )
    buckets = [f.buckets if isinstance(f, schur._FastBatch) and not info.implicit else None
               for f in info.fast]
    route = next((bi for bi, b in enumerate(buckets) if b is not None), None)
    return _shard(info, compiled.layout, [_host_batch(b) for b in compiled.batches], buckets,
                  route, compiled.manifolds, compiled.dtype, compiled.device, compiled.kernels,
                  mesh)


def compile_sharded(problem, mesh: Mesh, options: Options = None, unfixed=None,
                    plain: bool = False, dtype=None) -> ShardedSchurCompiled:
    """The compile of :func:`optimize_sharded`, run by every rank on the
    same problem: the global layout and routes on the host
    (``core.optimize.schur_routes``, which switches to the implicit solve
    where ``optimize`` would), then this rank's shard's tables, compiled
    and uploaded, and nothing of the other ranks' shards.
    ``options.solver`` ``"schur_cg"`` asks for the implicit solve,
    anything else for the direct one.  ``plain``: the plain PyTorch
    versions in place of the kernels, to hold the kernels against (as
    ``compile_problem``'s); ``dtype``: the shard's float type, by default
    the problem's (a float64 shard of a float32 problem is its yardstick)."""
    options = options or Options()
    if options.schur_family is None:
        raise ValueError("optimize_sharded requires Options(schur_family=...)")
    if problem.device != mesh.device:
        raise ValueError(f"the problem lives on {problem.device}, this rank's mesh on "
                         f"{mesh.device}")
    layout, info, batches, buckets, route = optimize.schur_routes(
        problem, options.schur_family, options.solver == "schur_cg", unfixed=unfixed)
    if problem.device.type == "cuda" and not plain:
        _build.library()
    manifolds = {n: problem.manifold_of(n) for n in problem.family_names()}
    return _shard(info, layout, batches, buckets, route, manifolds, dtype or problem.dtype,
                  problem.device, optimize.PLAIN if plain else optimize.KERNELS, mesh)


def optimize_sharded(problem, mesh: Mesh, options: Options = None, unfixed=None) -> Result:
    """The sharded counterpart of ``optimize`` on Schur problems, run by
    every rank on the same problem: :func:`compile_sharded`, then the host
    loop over the sharded system (:meth:`ShardedSchurCompiled.run`).  The
    problem's values end as the loop left them, the same on every rank;
    ``Result``'s phase times are measured (fenced, the collectives
    inside)."""
    options = options or Options()
    t0 = time.perf_counter()
    par = compile_sharded(problem, mesh, options, unfixed)
    vars0 = problem.stacked_variables()
    t1 = time.perf_counter()
    final = par.run(vars0, options)
    problem.set_values(final["variables"])
    times = [final["seconds"].get(k, 0.0) for k in ("cost", "assemble", "solve")]
    return optimize._result(final, t0, t1, times, final["trajectory"])
