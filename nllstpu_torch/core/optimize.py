"""Optimizer entry points: ``compile_problem``, the two drivers and
``optimize`` (port of ``nllstpu/core/optimize.py``): every iterator over
four backends — the dense normal equations (``solver="dense"``, any
batch form, autodiff or hand Jacobians), the matrix-free PCG over the same
per-cost blocks (``solver="cg"``), the direct Schur solve (with or
without a shared adaptive robust kernel, through either assembly route of
its obs-major batches) and the implicit one that ``solver="schur_cg"``
asks for and ``solver="schur"`` switches to past the dense-W limit;
``solver="auto"`` picks as the JAX package picks; ``unfixed`` picks the
variables to optimize.

Two drivers, dispatched as the JAX package dispatches its own:

* **graph driver** (:class:`_GraphRunner`, the counterpart of the JAX
  package's jit driver, whose whole optimization is one
  ``lax.while_loop``): on the card the assembly, the damped trial and the
  PCG's chunks are CUDA graphs, and the host replays them, reading a
  handful of scalars once per damping trial for the accept and
  termination decisions.  The default.
* **stepped driver** (:func:`run_stepped`): the host loop over eager
  calls, each phase ended by a device fence so that the phase times are
  real, with user callbacks and the full cost trajectory.  Taken when the
  caller passes a ``callback`` or ``store_trajectory=True``.

Both run :func:`run_loop`, the reference's control flow
(src/optimize.jl:109-180): unconditional adoption of the trial variables,
best-variable snapshot on the first consecutive failure with rollback at
the end, and the termination bitmask.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from ..ops import _build, cg, fused_obs, schur, schur_reduce, segment_sum, w_place
from ..utils import profiling
from . import engine, iterators, rules, structs
from .callbacks import host_array, print_row
from .problem import Problem, family_name
from .structs import Options, Result

#: Calls of :func:`compile_problem` and CUDA-graph captures of
#: :class:`_GraphRunner` (one per runner) in this process: what the runner
#: cache and ``SubproblemView`` save is read off these.
COMPILES = 0
CAPTURES = 0
#: Direct elimination stores W densely; past this size ``solver="schur"``
#: compiles the implicit solve instead, as the JAX package does.
DENSE_W_BYTE_LIMIT = 4 << 30
#: Assembly routes of the direct solve's obs-major batches (the JAX
#: package's ``NLLSTPU_W_IMPL``): "fused_all", one pass through kernel B1
#: (or B2 over every degree bucket) that writes the whole system; "fused", the
#: dual-sorted route, kernel B8 over landmark runs and a camera-major leg.
W_IMPLS = ("fused_all", "fused")


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The kernel entry points of the Schur paths (and B6, the dense and cg
    backends' fixed-order sums)."""

    assemble: Any  # kernel B1 contract (ops/fused_obs.py), uniform layouts
    assemble_into: Any  # kernel B2 contract, one launch per degree-bucketed batch
    assemble_leg: Any  # kernel B8 contract, the dual-sorted route
    reduce: Any  # kernel B3 contract (ops/schur_reduce.py), float32, over W's row tables
    reduce_lm: Any  # kernel B4 contract, f64-formed inverses, obs-major W's row tables
    reduce_external: Any  # kernel B5 contract, f64-formed inverses, over W's structure
    segment_sum: Any  # B6 contract (ops/segment_sum.py): implicit, generic, dense, cg, cameras
    place_w: Any  # kernel B7 contract (ops/w_place.py), generic direct path


#: Dispatchers: the hand-written kernels on CUDA tensors, their plain
#: versions on CPU tensors.
KERNELS = Kernels(
    fused_obs.fused_obs_all, fused_obs.fused_obs_all_into, fused_obs.fused_obs_leg,
    schur_reduce.reduce_s_damped, schur_reduce.reduce_s_lm, schur_reduce.reduce_s,
    segment_sum.segment_block_sum, w_place.place_w,
)
#: The plain PyTorch versions on any device — for measuring the kernels
#: against, never chosen implicitly.
PLAIN = Kernels(
    fused_obs.fused_obs_all_reference, fused_obs.fused_obs_all_into_reference,
    fused_obs.fused_obs_leg_reference,
    schur_reduce.reduce_s_damped_reference, schur_reduce.reduce_s_reference,
    schur_reduce.reduce_s_reference, segment_sum.segment_block_sum_reference,
    w_place.place_w_reference,
)


@dataclasses.dataclass
class CompiledProblem:
    """A problem lowered onto its device: padded batches and index tables
    uploaded once, the Schur layout (``schur_info``), the dense plan
    (``dense_plan``, :func:`engine.dense_plan`) or the matrix-free
    backend's ops (``cg_ops``, :func:`ops.cg.build_cg_ops`) fixed."""

    manifolds: dict
    layout: engine.Layout
    batches: list  # device batches (idx/mask/params tensors)
    dtype: Any
    device: Any
    schur_info: Any  # schur.SchurInfo, or None on the dense and cg backends
    kernels: Kernels = KERNELS
    dense_plan: Any = None  # engine.DensePlan on the dense backend
    cg_ops: Any = None  # cg.CGOps on the cg backend

    def __post_init__(self):
        self._step_index = engine.step_index(self.layout, self.manifolds, self.device)
        self._runs = None if self.schur_info is None else [
            (f.e_slot, f.buckets) if isinstance(f, schur._FastBatch) else None
            for f in self.schur_info.fast
        ]

    @property
    def implicit(self) -> bool:
        return self.schur_info is not None and self.schur_info.implicit

    def cost(self, variables):
        return engine.total_cost(self.batches, variables, runs_list=self._runs)

    def assemble(self, variables):
        if self.cg_ops is not None:
            return cg.assemble_cg(self.batches, variables, self.cg_ops)
        if self.schur_info is None:
            return engine.assemble_dense(self.batches, variables, self.dense_plan,
                                         self.kernels.segment_sum)
        if self.schur_info.implicit:
            return schur.assemble_implicit(
                self.batches, variables, self.schur_info, self.dtype,
                segment_sum=self.kernels.segment_sum,
            )
        return schur.assemble_schur(
            self.batches, variables, self.schur_info, self.dtype,
            assemble_kernel=self.kernels.assemble,
            assemble_into_kernel=self.kernels.assemble_into,
            segment_sum=self.kernels.segment_sum,
            place_w=self.kernels.place_w,
            assemble_leg=self.kernels.assemble_leg,
        )

    def apply(self, variables, x):
        return engine.apply_step(
            self.manifolds, self._step_index, self.layout.pad, variables, x
        )

    def ctx(self, options: Options = None, phase=None) -> iterators.IterCtx:
        """The iterators' context; ``options.linear_tol`` sets the PCG
        tolerance of the cg and implicit solves."""
        si = self.schur_info
        tol = None if options is None else options.linear_tol
        if self.cg_ops is not None:
            linops = dataclasses.replace(self.cg_ops, tol=tol, cg_iters=[])
        elif si is None:
            linops = iterators.DenseOps(self.layout.dof_total)
        elif si.implicit:
            csz = 0 if options is None else options.schur_cluster_size
            linops = schur.SchurCGOps(
                si.dim_reduced, si.num_elim, si.dof_elim, si.fams, si.cg, tol=tol,
                segment_sum=self.kernels.segment_sum,
                cluster=schur.cluster_plan(si, csz, self.device),
            )
        else:
            linops = schur.SchurOps(
                si.dim_reduced, reduce=self.kernels.reduce, reduce_lm=self.kernels.reduce_lm,
                reduce_external=self.kernels.reduce_external, pairs=si.w_pairs,
                rows=si.w_rows,
            )
        extra = {} if phase is None else {"phase": phase}
        return iterators.IterCtx(
            cost=self.cost,
            apply=self.apply,
            dtype=self.dtype,
            linops=linops,
            **extra,
        )


def _auto_dense_or_cg(problem, batches, layout):
    """The reference's dense-vs-sparse decision (the JAX package's
    ``_auto_dense_or_cg``, ``makesymmvls``): dense when d ≤ 40, else the
    scalar nonzeros of the lower-triangle block sparsity from the
    cost-variable incidence against the fill heuristic nnz·64 < 25·d·(d −
    40), "cg" (the JAX package's matrix-free backend) when sparse."""
    d = layout.dof_total
    if d <= 40:
        return "dense"
    base, total, dof_parts = {}, 0, []
    for name in problem.family_names():
        n = int(np.asarray(layout.offsets[name]).shape[0])
        base[name] = total
        total += n
        dof_parts.append(np.full(n, problem.manifold_of(name).dof, dtype=np.int64))
    dofs = np.concatenate(dof_parts) if dof_parts else np.zeros(0, np.int64)
    diag_ids, pair_keys = [], []
    for b in batches:
        mask = np.asarray(b.mask)
        gids = []
        for s, man in enumerate(b.manifolds):
            fam = family_name(man)
            idx = np.asarray(b.idx[s])
            unfixed = np.asarray(layout.offsets[fam])[idx] < layout.dof_total
            gids.append(np.where(unfixed & mask, base[fam] + idx, -1))
        for i in range(len(gids)):
            diag_ids.append(gids[i])
            for j in range(i + 1, len(gids)):
                lo = np.minimum(gids[i], gids[j]).astype(np.int64)
                hi = np.maximum(gids[i], gids[j]).astype(np.int64)
                keep = (lo >= 0) & (lo != hi)
                pair_keys.append(lo[keep] * total + hi[keep])
    nnz = 0
    if diag_ids:
        dv = np.unique(np.concatenate(diag_ids))
        dv = dv[dv >= 0]
        nnz += int((dofs[dv] ** 2).sum())
    if pair_keys:
        pk = np.unique(np.concatenate(pair_keys))
        nnz += int((dofs[pk // total] * dofs[pk % total]).sum())
    return "cg" if nnz * 64 < 25 * d * (d - 40) else "dense"


def _auto_schur_family(problem, batches, layout):
    """The eliminable ("landmark") family, as the JAX package's
    ``_auto_schur_family`` finds it: a family of dof ≤ 3 that no cost
    touches twice, with at least 64 unfixed variables holding at least
    half the tangent space, leaving a non-empty reduced system; the
    largest such.  None when no family qualifies."""
    counts = {name: 0 for name in problem.family_names()}
    for b in batches:
        per = collections.Counter(family_name(m) for m in b.manifolds)
        for name, k in per.items():
            if k > 1:
                counts[name] = -1
    best = None
    for name in problem.family_names():
        man = problem.manifold_of(name)
        if counts[name] < 0 or man.dof > 3:
            continue
        n_unfixed = int((np.asarray(layout.offsets[name]) < layout.dof_total).sum())
        fam_dof = n_unfixed * man.dof
        if n_unfixed < 64 or fam_dof * 2 < layout.dof_total:
            continue
        if layout.dof_total - fam_dof <= 0:
            continue
        if best is None or fam_dof > best[0]:
            best = (fam_dof, man)
    return None if best is None else best[1]


def auto_solver(problem: Problem, unfixed=None, schur_family=None, batches=None):
    """``(solver, schur_family)`` that ``solver="auto"`` compiles, as the
    JAX package picks them: Schur over ``schur_family`` when given; else
    dense for small or dense-enough systems (:func:`_auto_dense_or_cg`),
    and where the sparse "cg" backend would do, Schur over a detected
    landmark family (:func:`_auto_schur_family`), else "cg"."""
    if schur_family is not None:
        return "schur", schur_family
    batches = problem.batches() if batches is None else batches
    layout = engine.build_layout(problem, unfixed, batches=batches)
    if _auto_dense_or_cg(problem, batches, layout) == "dense":
        return "dense", None
    cand = _auto_schur_family(problem, batches, layout)
    return ("cg", None) if cand is None else ("schur", cand)


def compile_problem(problem: Problem, unfixed=None, solver: str = "dense",
                    schur_family=None, plain: bool = False,
                    w_impl: str = "fused_all") -> CompiledProblem:
    """Lower a problem onto its device.  ``solver``: "dense" (the
    default, as in the JAX package: the normal equations,
    :func:`engine.assemble_dense`; any batch form, fixed kernels), "cg" or
    "pcg" (the matrix-free PCG over the same per-cost blocks,
    :mod:`ops.cg`), "schur" (direct, unless its dense W would pass
    :data:`DENSE_W_BYTE_LIMIT`), "schur_cg" (implicit) — the Schur ones
    over ``schur_family`` — or "auto" (:func:`auto_solver`).  ``unfixed``
    selects the variables to optimize (:func:`engine.resolve_unfixed`;
    fixed cameras and fixed landmarks on every Schur path).  The Schur
    backends take every batch form, priors, pose-graph edges and several
    reduced families (the generic assembly: kernels B6, B7 and, direct,
    B5), and a bundle-adjustment batch with riders on the obs-major route
    (kernels B1/B2).  Skewed
    degree distributions get the JAX package's degree relabel (see
    :func:`schur_layout`); the direct path then takes the bucketed layout,
    assembled by kernel B2.  The host tables of kernels B2, B3/B4 (every
    obs-major direct W) and B5 (``schur_info.table_seconds``), the dense
    backend's plan and the cg backend's contribution order are built here,
    inside ``Result.time_init``.
    ``w_impl`` picks the direct assembly's route (:data:`W_IMPLS`);
    ``"fused"`` on a batch that does not qualify raises.  An adaptive
    kernel runs on every backend and batch form: its tangent leads each
    cost's blocks (``engine.batch_grad_hess``); on the direct path a
    components-major batch with one kernel variable takes its run tables
    and any other the generic route (kernels B6 and B7, the solve through
    B5), on the implicit one the generic coupling parts.  ``plain=True`` runs the
    kernels' plain PyTorch versions on every device (a baseline to measure
    the kernels against).  On a CUDA device with the kernels on, the
    kernel library is built (nvcc, at first use) and loaded here, so that
    the build counts as set-up (``Result.time_init``) and never against
    ``Options.max_time``, as the JAX package compiles before its budget
    clock starts; a failed build raises."""
    global COMPILES
    if w_impl not in W_IMPLS:
        raise ValueError(f"w_impl={w_impl!r}: the direct assembly's routes are {W_IMPLS}")
    COMPILES += 1
    if solver == "auto":
        with profiling.setup_span("nt.compile.layout"):
            solver, schur_family = auto_solver(problem, unfixed, schur_family)
    if solver not in ("dense", "cg", "pcg", "schur", "schur_cg"):
        raise ValueError(f"unknown solver {solver!r}")
    kernels = PLAIN if plain else KERNELS
    manifolds = {n: problem.manifold_of(n) for n in problem.family_names()}
    info = plan = cg_ops = None
    if solver in ("dense", "cg", "pcg"):
        if w_impl != "fused_all":
            raise ValueError(f"w_impl={w_impl!r} is a route of the direct Schur assembly")
        with profiling.setup_span("nt.compile.layout"):
            batches = problem.batches()
            layout = engine.build_layout(problem, unfixed, batches=batches)
        with profiling.setup_span("nt.compile.tables"):
            if solver == "dense":
                plan = engine.dense_plan(batches, layout, problem.device)
            else:
                cg_ops = cg.build_cg_ops(batches, layout, manifolds, problem.device,
                                         segment_sum=kernels.segment_sum)
    else:
        if schur_family is None:
            raise ValueError(f"solver={solver!r} requires schur_family")
        layout, info, batches = schur_layout(
            problem, schur_family, solver == "schur_cg", unfixed=unfixed, w_impl=w_impl
        )
        schur.check_slice(info, batches)
    if problem.device.type == "cuda" and not plain:
        _build.library()
    with profiling.setup_span("nt.compile.upload"):
        if info is not None:
            schur.upload_tables(info, problem.device, problem.dtype)
        return CompiledProblem(
            manifolds=manifolds,
            layout=layout,
            batches=[engine.device_batch(b, problem.device, problem.dtype) for b in batches],
            dtype=problem.dtype,
            device=problem.device,
            schur_info=info,
            kernels=kernels,
            dense_plan=plan,
            cg_ops=cg_ops,
        )


def schur_layout(problem: Problem, schur_family, implicit: bool = False,
                 unfixed=None, w_impl: str = "fused_all"):
    """Host half of the Schur compile: ``(layout, info, batches)`` of the
    ``unfixed`` variables.  Skewed degree distributions get the degree
    relabel (``order_key``), exactly as in the JAX package.  The direct
    solve takes the route :func:`schur.route_batches` decides: the obs-major
    route (the bucketed obs-major repack of its one coupling batch, on the
    dual-sorted route, ``w_impl="fused"``, a camera repack beside it; the
    rest ride along) or the generic route, every batch sorted by landmark;
    the implicit one (``implicit``, or a dense W past
    :data:`DENSE_W_BYTE_LIMIT`) sorts every batch by landmark.  A cost that
    touches the eliminated family twice raises ``ValueError``, as in the
    JAX package."""
    layout, info, batches, buckets, route = schur_routes(
        problem, schur_family, implicit, unfixed, w_impl)
    schur.fill_tables(info, layout, batches, buckets, route)
    return layout, info, batches


def schur_routes(problem: Problem, schur_family, implicit: bool = False,
                 unfixed=None, w_impl: str = "fused_all"):
    """:func:`schur_layout` without the tables: ``(layout, info, batches,
    buckets, route)``, ``info`` the split and the solve's kind (its
    ``fast`` empty), ``buckets`` and ``route`` as
    :func:`schur.route_batches` gives them (None on the implicit solve).
    The landmark-sharded compile (``parallel.schur_shard``) starts here and
    builds only its own shard's tables."""
    with profiling.setup_span("nt.compile.layout"):
        batches = problem.batches()
        counts = schur.elim_degree_counts(batches, problem, schur_family)
        order_key = None
        if counts.size and counts.sum() > 0:
            if counts.size * counts.max() > schur._OBS_MAJOR_MAX_RATIO * counts.sum():
                order_key = {family_name(schur_family): counts}
        layout = engine.build_layout(
            problem, unfixed, batches=batches, order_last=family_name(schur_family),
            order_key=order_key,
        )
        pre = schur.build_schur_info(problem, layout, schur_family)
        schur.check_elim_slots(batches, pre)
        # The JAX package's dense-W size, pad column block included.
        w_bytes = (
            pre.num_elim * (pre.dim_reduced + layout.pad) * pre.dof_elim
            * torch.empty((), dtype=problem.dtype).element_size()
        )
        implicit = implicit or w_bytes > DENSE_W_BYTE_LIMIT
        if implicit:
            batches, buckets, route = [schur.sort_for_implicit(b, pre) for b in batches], None, None
        else:
            batches, buckets, route = schur.route_batches(batches, pre, layout, problem.dtype)
        info = dataclasses.replace(pre, implicit=implicit, w_impl=w_impl)
        return layout, info, batches, buckets, route


@dataclasses.dataclass
class CallbackContext:
    """What a user callback sees (the JAX package's ``CallbackContext``).
    ``variables`` holds the trial variables of the current iteration; the
    callback may replace entries, and the loop adopts what it leaves there
    (reference callbacks mutate ``problem.varnext``).  ``cost_fn`` is the
    compiled total cost, for recomputing the cost after a change;
    ``itdata`` the iterator's scalars (``lm_lambda``)."""

    problem: Problem
    variables: dict
    step: Any
    bestcost: float
    iteration: int
    cost_fn: Callable
    itdata: dict


def _same(x):
    return x


def run_loop(assemble_fn, cost_fn, ctx, opts: Options, vars0, callback=None,
             problem=None, trajectory=None, buffers=None, times=None) -> dict:
    """The outer optimization (reference ``optimizeinternal!``) over a dict
    of device tensors.  Returns the final state: ``variables`` (rolled back
    to the best ones when the last iterate is worse), ``startcost``,
    ``bestcost``, ``iternum``, ``converged`` (termination bits), the
    ``ncost``/``ngrad``/``nsolve`` counters, ``trace`` (the cost after
    every iteration) and ``step_norms`` (|x| of every iteration's step).

    ``ctx`` is an :class:`iterators.IterCtx`, or the graph driver's
    :class:`_GraphRunner`, which offers the same members.  ``callback(cost,
    CallbackContext) -> (cost, flags)`` runs after every iteration; its
    nonzero flags end the run, shifted into the termination bits.
    ``trajectory`` (a :class:`structs.CostTrajectory`) gets every
    iteration's cost, time since the loop's start and step vector.
    ``buffers`` (the graph driver) holds the variables in static tensors:
    ``buffers.adopt(nv)`` copies the adopted variables in and returns them,
    ``buffers.snapshot(v)`` clones; without it both return their
    argument.  ``times`` (a list) gets every iteration's time since the
    loop's start in ns; ``opts.jit_printout`` prints a row per
    iteration."""
    t = ctx.np_dtype
    adopt = buffers.adopt if buffers is not None else _same
    snapshot = buffers.snapshot if buffers is not None else _same
    t0 = time.perf_counter()
    with ctx.phase("cost"):
        c0 = t(cost_fn(vars0).item())
    st = dict(
        variables=vars0, varbest=vars0, bestcost=c0, lastcost=c0,
        startcost=c0, itdata=iterators.init_data(t, opts), fails=0,
        iternum=0, converged=0, ncost=1, ngrad=0, nsolve=0, trace=[],
        step_norms=[],
    )
    if opts.jit_printout:
        print_row(0, c0, c0, 0.0, st["itdata"])
    with np.errstate(all="ignore"):
        while st["converged"] == 0:
            with ctx.phase("assemble"):
                _, sys = assemble_fn(st["variables"])
            nv, c, x, itdata, ns, nc, maxstep, xx = iterators.iterate(
                opts.iterator, ctx, sys, st["variables"], st["bestcost"],
                st["itdata"], opts,
            )
            iternum = st["iternum"] + 1
            user = 0
            if callback is not None:
                cb = CallbackContext(
                    problem=problem, variables=dict(nv), step=x,
                    bestcost=float(st["bestcost"]), iteration=iternum,
                    cost_fn=cost_fn, itdata=itdata,
                )
                c, user = callback(c, cb)
                c = t(float(c))
                nv = cb.variables
            prev_best = st["bestcost"]
            accepted, fails, bestcost, bits = rules.outer_update(
                c, prev_best, maxstep, st["fails"], iternum, opts)
            if not accepted and st["fails"] == 0:
                st["varbest"] = snapshot(st["variables"])
            if time.perf_counter() - t0 > opts.max_time:
                bits |= structs.TERM_MAX_TIME
            bits |= int(user) << structs.TERM_USER_SHIFT
            st.update(
                variables=adopt(nv), bestcost=bestcost, lastcost=c, itdata=itdata,
                fails=fails, iternum=iternum, converged=bits,
                ncost=st["ncost"] + nc, ngrad=st["ngrad"] + 1,
                nsolve=st["nsolve"] + ns,
            )
            st["trace"].append(c)
            st["step_norms"].append(np.sqrt(xx))
            if trajectory is not None:
                trajectory.costs.append(float(c))
                trajectory.times_ns.append(int((time.perf_counter() - t0) * 1e9))
                trajectory.trajectory.append(host_array(x))
            if times is not None:
                times.append(int((time.perf_counter() - t0) * 1e9))
            if opts.jit_printout:
                print_row(iternum, c, prev_best, np.sqrt(xx), itdata)
        if not (st["bestcost"] >= st["lastcost"]):
            st["variables"] = st["varbest"]
    return st


@contextlib.contextmanager
def _cusolver(device):
    """PyTorch's dense factorizations through cuSOLVER on the card: not
    MAGMA, which reads its ``info`` on the host and cannot be captured.
    Both drivers run under it (the graph driver's warm-up and captures,
    the stepped driver's loop), so that they factor alike: the implicit
    path's batched preconditioner blocks would otherwise go to MAGMA in the
    stepped driver alone."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


class _PhaseClock:
    """The stepped driver's phase hook: the host seconds of each phase,
    each ended by a device fence (``torch.cuda.synchronize`` on the card),
    so that they time the device's work and not its enqueue; ``inner``, the
    caller's own hook (CUDA events, say), runs inside."""

    def __init__(self, device, inner=None):
        self.device = device
        self.inner = inner or iterators._no_phase
        self.seconds = collections.defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name):
        t = time.perf_counter()
        with self.inner(name):
            yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] += time.perf_counter() - t


def run_stepped(compiled: CompiledProblem, opts: Options, vars0, callback=None,
                problem=None, phase=None) -> dict:
    """The stepped driver (the JAX package's ``_run_stepped``): the host
    loop over eager calls, every phase ended by a device fence.  Returns
    :func:`run_loop`'s final state with ``seconds`` (host seconds per phase:
    "assemble", "solve", "cost"), ``trajectory`` (a
    :class:`structs.CostTrajectory` when ``opts.store_trajectory`` is
    True, else None) and ``cg_iters`` (the cg and implicit paths' PCG
    iterations per solve).  ``phase`` is an extra phase hook inside the
    fences."""
    clock = _PhaseClock(compiled.device, phase)
    trajectory = structs.CostTrajectory() if opts.store_trajectory is True else None
    ctx = compiled.ctx(opts, phase=clock)
    with _cusolver(compiled.device):
        final = run_loop(
            compiled.assemble, compiled.cost, ctx, opts, vars0,
            callback=callback, problem=problem, trajectory=trajectory,
        )
    final.update(seconds=dict(clock.seconds), trajectory=trajectory,
                 cg_iters=list(getattr(ctx.linops, "cg_iters", [])))
    return final


#: The kernels' launch counters, ``(module, attribute)``: each wrapper adds
#: one where it launches its kernel; the graph driver adds what a capture
#: counted once per replay of it, when its run returns
#: (:meth:`_GraphRunner._tally_launches`).
LAUNCH_COUNTERS = (
    (fused_obs, "LAUNCHES"), (fused_obs, "INTO_LAUNCHES"), (fused_obs, "LEG_LAUNCHES"),
    (schur_reduce, "LAUNCHES"), (schur_reduce, "LM_LAUNCHES"),
    (schur_reduce, "EXTERNAL_LAUNCHES"), (segment_sum, "LAUNCHES"), (w_place, "LAUNCHES"),
)


def _launch_counts() -> list:
    return [getattr(m, a) for m, a in LAUNCH_COUNTERS]


def _set_launch_counts(counts) -> None:
    for (m, a), n in zip(LAUNCH_COUNTERS, counts):
        setattr(m, a, n)


def _add_launch_counts(counts, times: int = 1) -> None:
    for (m, a), n in zip(LAUNCH_COUNTERS, counts):
        if n:
            setattr(m, a, getattr(m, a) + n * times)


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    """The warm-up stream of every runner on ``device``: one per device,
    since the cuBLAS workspaces PyTorch keeps per stream would otherwise
    stay allocated (64 MiB on the H100) for every runner ever built."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _GraphRunner:
    """The graph driver: the counterpart of the JAX package's jit driver
    (``_JitRunner`` over ``_loop_machine``, nllstpu/core/optimize.py), whose
    whole optimization is one ``lax.while_loop``.  Here the loop's control
    stays :func:`run_loop`'s, on the host, and what it runs between two
    host reads is one CUDA graph.

    The pieces, each a body over the runner's static tensors (the
    variables ``vars``, λ — or a combination trial's scalar s — as a 0-d
    float64 tensor ``lam``, the system ``sys`` and its gradient ``g``, the
    dogleg legs ``xn`` and ``cauchy``), only those the iterator runs:

    - ``assemble``: the system and its gradient at ``vars``;
    - direct and dense, LM and Newton: ``trial`` and ``trial_lu``, the
      damped step at ``lam`` through the (reduced) system's Cholesky or
      LU, the variables it gives, their cost and the read ``[cost,
      max|x|, gᵀx, xᵀx, ok]``;
    - cg and implicit (the backends whose linear ops have PCG pieces), LM
      and Newton: ``pcg_setup`` (preconditioner, tolerance, start state;
      implicit: damped inverses and the reduced rhs before them),
      ``pcg_chunk`` (``linearsolver.CG_CHECK_EVERY`` iterations in place,
      and the convergence flag) and ``pcg_finish`` (the step — implicit:
      through the back-substitution —, its cost, the read);
    - dogleg: ``leg`` and ``leg_lu`` (direct and dense: the undamped solve
      at a zero λ in device memory, fused with gᵀHg) or, cg and implicit,
      ``pcg_setup`` and ``pcg_chunk`` at λ = 0 and ``pcg_leg``; each writes
      the legs into ``xn`` and ``cauchy`` and gives the read ``[gᵀg, gᵀHg,
      x_nᵀx_n, |x_n − c|², cᵀ(x_n − c), ok]``
      (:func:`iterators.leg_tensors`); then ``trial_cauchy``,
      ``trial_newton`` and ``trial_blend``, the combination trials of
      :func:`iterators.combo_step` at s = ``lam``;
    - gradient descent: ``trial_gradient`` (x = −g·s).

    On the card :meth:`prepare` runs every piece once on a side stream
    (the warm-up: the kernels' scratch, cuBLAS and cuSOLVER workspaces and
    the kernels' first attribute calls happen there), then captures each
    in a CUDA graph, all in one memory pool; a failed capture raises and
    names the piece.  A trial is then one write of λ or s, one replay and
    one read (a second replay and read when a Cholesky failed; on the
    cg and implicit paths a replay and a flag read per PCG chunk), an outer
    iteration one copy of the adopted variables into ``vars`` and one
    assembly replay.  ``piece_replays`` counts each piece's replays in the
    run; when the run returns, the kernels' launch counters get what each
    capture counted once per replay.  On the CPU the pieces run eagerly:
    the same code, counted alike.  A compile with the plain versions
    (``plain=True``) cannot be captured (its kernels' plain versions read
    the host); on the card the runner refuses it.  Every piece's replay
    and the host read of its outputs run inside its span
    ``nt.piece.<piece>`` (:func:`profiling.span`); ``phase(name)`` wraps
    the replay alone."""

    def __init__(self, compiled: CompiledProblem, opts: Options, vars0, phase=None):
        capture = compiled.device.type == "cuda"
        if capture and compiled.kernels is not KERNELS:
            raise ValueError(
                "graph driver: a compile with the kernels' plain versions (plain=True) "
                "cannot be captured in CUDA graphs; drive it with run_loop"
            )
        self.compiled, self.opts = compiled, opts
        ctx = compiled.ctx(opts)
        self.linops, self.np_dtype = ctx.linops, ctx.np_dtype
        self.phase = iterators._no_phase  # run_loop's hooks: the pieces are timed instead
        self.timer = phase or iterators._no_phase
        # The PCG pieces where the backend's linear ops have them (cg and
        # implicit), else the damped trial through a factorisation.
        self.iterative = hasattr(self.linops, "pcg_chunk")
        self.vars = {k: v.clone() for k, v in vars0.items()}
        self.lam = torch.zeros((), dtype=torch.float64, device=compiled.device)
        self.zero = torch.zeros((), dtype=torch.float64, device=compiled.device)
        self.xn = self.cauchy = None
        # store_trajectory="jit_full": every trial writes its step into row
        # ``row`` of ``steps`` inside its graph; the adopted trial writes
        # last, and each assembly moves ``row`` on.
        self.steps = self.row = None
        self.iteration = 0
        if opts.store_trajectory == "jit_full":
            self.steps = torch.full((opts.max_iters, compiled.layout.dof_total), float("nan"),
                                    dtype=compiled.dtype, device=compiled.device)
            self.row = torch.zeros(1, dtype=torch.long, device=compiled.device)
        it = opts.iterator
        damped = it in (structs.LEVENBERG_MARQUARDT, structs.NEWTON)
        self.bodies = {"assemble": self._assemble}
        if self.iterative and it != structs.GRADIENT_DESCENT:
            self.bodies.update(pcg_setup=self._pcg_setup, pcg_chunk=self._pcg_chunk)
        if damped:
            self.bodies.update(
                {"pcg_finish": self._pcg_finish} if self.iterative else
                {"trial": self._trial, "trial_lu": lambda: self._trial(lu=True)})
        if it == structs.DOGLEG:
            self.bodies.update(
                {"pcg_leg": self._pcg_leg} if self.iterative else
                {"leg": self._leg, "leg_lu": lambda: self._leg(lu=True)})
            for kind in iterators.COMBOS[:3]:
                self.bodies["trial_" + kind] = functools.partial(self._combo, kind)
        if it == structs.GRADIENT_DESCENT:
            self.bodies["trial_gradient"] = functools.partial(self._combo, "gradient")
        self.graphs = {}  # name -> (CUDAGraph, launch counts of its capture, outputs)
        self.spans = {name: "nt.piece." + name for name in self.bodies}
        self.capture_seconds = 0.0
        self.piece_replays = collections.Counter()  # this run's, per piece
        if capture:
            self.prepare()

    # -- the pieces' bodies ------------------------------------------------

    def _assemble(self):
        _, sys = self.compiled.assemble(self.vars)
        return sys, self.linops.grad(sys)

    def _finish_trial(self, x, ok):
        if self.steps is not None:
            self.steps.index_copy_(0, self.row, x[None])
        nv = self.compiled.apply(self.vars, x)
        return nv, x, iterators.trial_read(self.compiled.cost(nv), x, self.g, ok)

    def _trial(self, lu=False):
        x, ok = self.linops.solve_ex(self.sys, self.lam, lu=lu)
        return self._finish_trial(-x, ok)

    def _keep_legs(self, xsol, ghg, ok):
        """The legs into the static ``xn``/``cauchy`` (every leg piece
        writes the same buffers, which the combination trials read); the
        read."""
        xn, cauchy, read = iterators.leg_tensors(self.g, xsol, ghg, ok)
        self.xn.copy_(xn)
        self.cauchy.copy_(cauchy)
        return read

    def _leg(self, lu=False):
        return self._keep_legs(*self.linops.leg_ex(self.sys, self.zero, lu))

    def _combo(self, kind):
        s = self.lam.to(self.g.dtype)
        return self._finish_trial(
            iterators.combo_step(kind, self.g, (self.xn, self.cauchy), s), None)

    def _pcg_setup(self):
        return self.linops.pcg_setup(self.sys, self.lam)

    def _pcg_chunk(self):
        h_inv, inv, tol2, state = self.pcg
        new, flag = self.linops.pcg_chunk(self.sys, self.lam, h_inv, inv, tol2, state)
        for buf, value in zip(state, new):
            buf.copy_(value)
        return flag

    def _pcg_x(self):
        h_inv, _, _, state = self.pcg
        return self.linops.pcg_finish(self.sys, h_inv, state)

    def _pcg_finish(self):
        return self._finish_trial(-self._pcg_x(), None)

    def _pcg_leg(self):
        return self._keep_legs(self._pcg_x(), self.linops.quad(self.sys, self.g), None)

    def _keep(self, name, out):
        """Outputs that later pieces read become the runner's."""
        if name == "assemble":
            self.sys, self.g = out
            if self.xn is None:
                self.xn, self.cauchy = torch.empty_like(self.g), torch.empty_like(self.g)
        elif name == "pcg_setup":
            self.pcg = out
        return out

    # -- capture and replay ------------------------------------------------

    @property
    def replays(self) -> int:
        """This run's replays of every piece."""
        return sum(self.piece_replays.values())

    def prepare(self):
        """Warm-up and capture (see the class), then one replay of each
        graph, whose first replay uploads it: the set-up spans
        ``nt.graph.warmup``, ``nt.graph.capture`` and ``nt.graph.upload``,
        their seconds summed in ``capture_seconds``."""
        global CAPTURES
        CAPTURES += 1
        dev = self.compiled.device
        with _cusolver(dev):
            with profiling.setup_span("nt.graph.warmup") as warmup:
                self.lam.fill_(1.0)
                side = _side_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for name, body in self.bodies.items():
                        self._keep(name, body())
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
            with profiling.setup_span("nt.graph.capture") as capture:
                self._capture()
            with profiling.setup_span("nt.graph.upload") as upload:
                for graph, counted, _ in self.graphs.values():  # the first replay uploads it
                    graph.replay()
                    _add_launch_counts(counted)
                torch.cuda.synchronize(dev)
        self.capture_seconds = warmup.seconds + capture.seconds + upload.seconds

    def _capture(self):
        """Each piece captured in a CUDA graph, all in one memory pool."""
        pool = torch.cuda.graph_pool_handle()
        # No garbage collection inside a capture: a collected runner's
        # CUDA graph (runners hold reference cycles) would be destroyed
        # mid-capture, which invalidates it.  ``torch.cuda.graph``
        # collects before each capture begins.
        gc_on = gc.isenabled()
        gc.disable()
        try:
            for name, body in self.bodies.items():
                graph = torch.cuda.CUDAGraph()
                before = _launch_counts()
                try:
                    with torch.cuda.graph(graph, pool=pool):
                        out = self._keep(name, body())
                except Exception as e:
                    raise RuntimeError(
                        f"graph driver: the capture of {name!r} failed: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                counted = [a - b for a, b in zip(_launch_counts(), before)]
                _set_launch_counts(before)  # nothing ran during the capture
                self.graphs[name] = (graph, counted, out)
        finally:
            if gc_on:
                gc.enable()

    def _tally_launches(self):
        """Adds to the kernels' launch counters what each graph's capture
        counted, once per replay of this run (when :meth:`run` returns)."""
        for name, (_, counted, _) in self.graphs.items():
            if self.piece_replays[name]:
                _add_launch_counts(counted, self.piece_replays[name])

    def _step(self, name, read=None):
        """Piece ``name``: its graph replayed on the card, its body run on
        the CPU, and ``read``, the host read of its outputs, if given, all
        inside its span; returns the outputs, or what ``read`` makes of
        them."""
        with profiling.span(self.spans[name]):
            with self.timer(name):
                if name in self.graphs:
                    graph, _, out = self.graphs[name]
                    graph.replay()
                else:
                    out = self.bodies[name]()
            self.piece_replays[name] += 1
            out = self._keep(name, out)
            return out if read is None else read(out)

    @staticmethod
    def _read_trial(out):
        nv, x, read = out
        return nv, x, read.tolist()

    def _pcg(self, lam):
        """The PCG set-up and chunks at ``lam``, the host reading the
        convergence flag after each chunk."""
        self.lam.fill_(float(lam))
        self._step("pcg_setup")
        more = True
        while more:
            more, iters = self._step("pcg_chunk", torch.Tensor.tolist)
        self.linops.cg_iters.append(int(iters))

    # -- what run_loop and the iterators call --------------------------------

    def assemble(self, variables):
        if self.row is not None:
            self.row.fill_(self.iteration)
        self.iteration += 1
        return None, self._step("assemble")[0]

    def grad(self, sys):
        return self.g

    def trial(self, sys, g, variables, lam, lu=False):
        """The damped trial at ``lam`` (:meth:`iterators.IterCtx.trial`'s
        contract) through the pieces."""
        if self.iterative:
            self._pcg(lam)
            return self._step("pcg_finish", self._read_trial)
        self.lam.fill_(float(lam))
        return self._step("trial_lu" if lu else "trial", self._read_trial)

    def leg(self, sys, g, lu=False):
        """Dogleg's leg (:meth:`iterators.IterCtx.leg`'s contract); the
        legs stay in the runner's buffers."""
        if self.iterative:
            self._pcg(0.0)
            return None, self._step("pcg_leg", torch.Tensor.tolist)
        return None, self._step("leg_lu" if lu else "leg", torch.Tensor.tolist)

    def combo(self, sys, g, variables, legs, kind, s):
        """A combination trial (:meth:`iterators.IterCtx.combo`'s
        contract): s written into ``lam``, one replay, one read."""
        self.lam.fill_(float(s))
        return self._step("trial_" + kind, self._read_trial)

    def adopt(self, variables):
        for name, v in variables.items():
            self.vars[name].copy_(v)
        return self.vars

    @staticmethod
    def snapshot(variables):
        return {name: v.clone() for name, v in variables.items()}

    def reset(self, vars0):
        """Start a new run from ``vars0`` on the captured graphs (the
        runner cache's hit, ``SubproblemView``'s next subset): the values
        copied into the static variables, the counters cleared; nothing is
        compiled or captured."""
        self.adopt(vars0)
        self.piece_replays.clear()
        self.iteration = 0
        self.capture_seconds = 0.0
        if hasattr(self.linops, "cg_iters"):
            self.linops.cg_iters.clear()

    def release(self):
        """Drop the graphs and the static tensors, so that their memory
        pool returns to the allocator (an evicted cache entry)."""
        self.graphs.clear()
        self.bodies.clear()
        self.vars = {}
        self.sys = self.g = self.pcg = self.xn = self.cauchy = self.steps = None

    def run(self) -> dict:
        """:func:`run_loop` through the pieces; the final variables are the
        caller's own tensors (a later replay does not touch them), the
        launches tallied.  The final state has ``replays`` (per piece),
        ``capture_seconds`` and ``cg_iters``; with ``jit_max_time`` every
        iteration's time (``times_ns``); under
        ``store_trajectory="jit_full"`` every iteration's step (``steps``,
        host arrays).  What follows the loop runs in span ``nt.finish``."""
        times = [] if self.opts.jit_max_time else None
        final = run_loop(self.assemble, self.compiled.cost, self, self.opts, self.vars,
                         buffers=self, times=times)
        with profiling.span("nt.finish"):
            self._tally_launches()
            if final["variables"] is self.vars:
                final["variables"] = self.snapshot(self.vars)
            steps = ([] if self.steps is None else
                     list(self.steps[: final["iternum"]].cpu().numpy()))
            final.update(capture_seconds=self.capture_seconds, replays=dict(self.piece_replays),
                         cg_iters=list(getattr(self.linops, "cg_iters", [])),
                         times_ns=times or [], steps=steps)
        return final


def run_graphs(compiled: CompiledProblem, opts: Options, vars0, phase=None) -> dict:
    """The graph driver over a compiled problem (:class:`_GraphRunner`:
    warm-up and capture, then the loop).  Returns :func:`run_loop`'s final
    state with ``capture_seconds``, ``replays`` (per piece) and
    ``cg_iters`` (as :func:`run_stepped`'s)."""
    return _GraphRunner(compiled, opts, vars0, phase).run()


def cost(problem: Problem) -> float:
    """The problem's total cost at its current values (reference
    ``cost(problem)``)."""
    batches = [engine.device_batch(b, problem.device, problem.dtype) for b in problem.batches()]
    return float(engine.total_cost(batches, problem.stacked_variables()))




def _unfixed_cache_key(unfixed):
    """A hashable form of ``unfixed`` (the JAX package's)."""
    from .manifolds import Manifold
    from .problem import VarHandle

    if unfixed is None or isinstance(unfixed, Manifold):
        return unfixed
    if isinstance(unfixed, VarHandle):
        return (unfixed.family, unfixed.index)
    if isinstance(unfixed, dict):
        return tuple((name, tuple(np.asarray(m, dtype=bool).tolist()))
                     for name, m in sorted(unfixed.items()))
    return tuple((h.family, h.index) for h in unfixed)


#: LRU capacity of the runner cache: alternation workflows swap between a
#: handful of (problem, options, unfixed) configurations — EM over two
#: subproblems, say — and must not compile or capture on every call.
_RUNNER_CACHE_SIZE = 8
_runner_cache: dict = {}  # insertion-ordered: the first entry is the least recent


class _RunnerEntry:
    """A cache slot: the compiled problem and its graph runner, built at
    the first run and reset at every later one."""

    def __init__(self, compiled: CompiledProblem, opts: Options):
        self.compiled, self.opts, self._runner = compiled, opts, None

    def runner(self, vars0) -> "_GraphRunner":
        if self._runner is None:
            self._runner = _GraphRunner(self.compiled, self.opts, vars0)
        else:
            self._runner.reset(vars0)
        return self._runner

    def release(self):
        if self._runner is not None:
            self._runner.release()
        self._runner = self.compiled = None


def _drop_entry(key):
    hit = _runner_cache.pop(key, None)
    if hit is not None:
        hit[0].release()


def clear_runner_cache():
    """Release every cached runner (graphs, pools, compiled problems)."""
    for key in list(_runner_cache):
        _drop_entry(key)


def _cached_entry(problem, opts: Options, unfixed, w_impl) -> _RunnerEntry:
    """The compiled problem and graph runner of ``(problem, opts, unfixed,
    w_impl)``, reused while the problem's structure is unchanged (value
    edits keep it: a hit copies the current values into the runner's
    static tensors), as the JAX package's ``_cached_entry`` reuses its
    compiled runner: an LRU of :data:`_RUNNER_CACHE_SIZE`, keyed by the
    problem's ``id`` (checked through a weakref) and ``structure_version``;
    the kernels' dispatchers and the dense-W limit are part of the key.  An
    entry is released — its graphs and their memory pool with it — when
    it is evicted and when its problem is collected."""
    key = (id(problem), problem.structure_version, opts, _unfixed_cache_key(unfixed),
           w_impl, KERNELS, DENSE_W_BYTE_LIMIT)
    hit = _runner_cache.pop(key, None)
    if hit is not None:
        if hit[1]() is problem:
            _runner_cache[key] = hit  # re-inserted: the most recent
            return hit[0]
        hit[0].release()
    compiled = compile_problem(problem, unfixed, solver=opts.solver,
                               schur_family=opts.schur_family, w_impl=w_impl)
    entry = _RunnerEntry(compiled, opts)
    while len(_runner_cache) >= _RUNNER_CACHE_SIZE:
        _drop_entry(next(iter(_runner_cache)))
    _runner_cache[key] = (entry, weakref.ref(problem))
    weakref.finalize(problem, _drop_entry, key)
    return entry


def _result(final, t0, t1, times, trajectory, setup=None) -> Result:
    """The call's :class:`Result` (``setup``: its set-up record, if any);
    its counters added to :func:`profiling.totals`."""
    res = Result(
        start_cost=float(final["startcost"]),
        best_cost=float(final["bestcost"]),
        time_total=time.perf_counter() - t0,
        time_init=t1 - t0,
        time_cost=times[0],
        time_gradient=times[1],
        time_solver=times[2],
        termination=final["converged"],
        num_iterations=final["iternum"],
        cost_computations=final["ncost"],
        gradient_computations=final["ngrad"],
        linear_solves=final["nsolve"],
        costs=[float(c) for c in final["trace"]],
        trajectory=trajectory,
        replays=dict(final.get("replays", {})),
        pcg_iterations=[int(k) for k in final.get("cg_iters", [])],
        setup_seconds=dict(setup or {}),
    )
    total = profiling.totals()
    total.update(optimize_calls=1, iterations=res.num_iterations,
                 linear_solves=res.linear_solves, pcg_solves=len(res.pcg_iterations),
                 pcg_iterations=sum(res.pcg_iterations))
    total.update({"replays." + k: n for k, n in res.replays.items()})
    total.update({"setup." + k: s for k, s in res.setup_seconds.items()})
    return res


def _graph_trajectory(final, opts: Options):
    """The graph driver's :class:`structs.CostTrajectory` under
    ``store_trajectory="jit"`` or ``"jit_full"``, else None."""
    if opts.store_trajectory not in ("jit", "jit_full"):
        return None
    return structs.CostTrajectory(
        costs=[float(c) for c in final["trace"]],
        times_ns=list(final["times_ns"]),
        trajectory=list(final["steps"]),
        step_norms=[float(n) for n in final["step_norms"]],
    )


def optimize(problem: Problem, options: Options = None, unfixed=None, callback=None,
             w_impl: str = "fused_all") -> Result:
    """Optimize the ``unfixed`` variables (all by default; see
    :func:`engine.resolve_unfixed`) in place on the problem's device and
    return a :class:`Result` (reference ``optimize!``).  ``w_impl`` picks
    the direct assembly's route (:data:`W_IMPLS`).

    The driver is picked as the JAX package picks it: a ``callback(cost,
    CallbackContext) -> (cost, flags)`` or ``store_trajectory=True`` runs
    the stepped driver (:func:`run_stepped`: real phase times, the full
    :class:`structs.CostTrajectory`), anything else the graph driver
    (:class:`_GraphRunner`; ``store_trajectory="jit"`` records costs and
    step norms, ``"jit_full"`` the steps too), whose warm-up and captures
    count in ``time_init``, before ``max_time``'s clock starts, as the JAX
    package compiles before its.  The graph driver's compiled problem and
    runner are cached (:func:`_cached_entry`): a second call on a problem
    whose structure is unchanged compiles and captures nothing, and its
    ``time_init`` is the copy of the current values into the runner.

    The call runs in span ``nt.optimize``: set-up in ``nt.setup`` (its
    phases in ``nt.compile.*`` and ``nt.graph.*``, their seconds in
    ``Result.setup_seconds``), the loop, then ``nt.finish``."""
    options = options or Options()
    stepped = callback is not None or options.store_trajectory is True
    with profiling.span("nt.optimize"), profiling.setup_record() as setup:
        with profiling.setup_span("nt.setup"):
            if not any(m.any() for m in engine.resolve_unfixed(problem, unfixed).values()):
                raise ValueError("no unfixed variables to optimize")
            t0 = time.perf_counter()
            if stepped:
                compiled = compile_problem(
                    problem, unfixed, solver=options.solver,
                    schur_family=options.schur_family, w_impl=w_impl,
                )
                vars0 = problem.stacked_variables()
            else:
                runner = _cached_entry(problem, options, unfixed, w_impl).runner(
                    problem.stacked_variables())
        t1 = time.perf_counter()
        if stepped:
            final = run_stepped(compiled, options, vars0, callback=callback, problem=problem)
            times = [final["seconds"].get(k, 0.0) for k in ("cost", "assemble", "solve")]
            trajectory = final["trajectory"]
        else:
            final = runner.run()
            nan = float("nan")
            times = [nan, nan, nan]
            trajectory = _graph_trajectory(final, options)
        with profiling.span("nt.finish"):
            problem.set_values(final["variables"])
            return _result(final, t0, t1, times, trajectory, setup)


class SubproblemView:
    """A reusable cost-subset view of one problem (the JAX package's
    ``SubproblemView``, reference ``subproblem!``): compiled ONCE with
    every real cost live, then the active subset is swapped as a value.
    The compiled batches' ``mask`` tensors are the view's: every device
    consumer of a batch — the costs' sums, the dense assembly, the
    obs-major assembly's ρ′·mask and 2ρ″·mask (kernels B1/B2), the generic
    route's blocks — reads them, so the captured graphs (one runner per
    ``Options`` value) take a new subset without capturing again.
    :meth:`select` writes them with ``copy_``, mapped through each batch's
    compile-time reordering (the obs-major and landmark-sorted repacks,
    ``CostBatch.take``) and ANDed with the compile-time mask.

    ``solver="dense"`` (default) or ``"schur"`` (with ``schur_family``);
    the implicit backend is refused, as in the JAX package.  Use a damped
    iterator (LM, dogleg): variables touched by no active cost have zero
    gradient and Hessian rows and get a zero step from the damped solve.
    ``compile_count`` stays 1 and ``capture_count`` (CUDA-graph captures,
    one per ``Options`` value on the card, 0 on the CPU) across swaps.

    Usage::

        view = SubproblemView(problem)
        view.select(handle_or_predicate)
        res = view.optimize(options)
    """

    def __init__(self, problem: Problem, unfixed=None, solver: str = "dense",
                 schur_family=None):
        self.problem = problem
        self._structure_version = problem.structure_version
        if solver not in ("dense", "schur"):
            raise ValueError("SubproblemView supports solver='dense' or 'schur'")
        self.compiled = compile_problem(problem, unfixed, solver=solver,
                                        schur_family=schur_family)
        self.compile_count = 1
        if self.compiled.implicit:
            raise ValueError(
                "SubproblemView over the implicit Schur backend is not supported "
                "(mask-dependent preconditioner structure); use solver='schur' under "
                "the dense-W byte budget or rebuild per subset via Problem.subproblem"
            )
        if self.compiled.layout.dof_total == 0:
            raise ValueError("no unfixed variables to optimize")
        dev = self.compiled.device
        self._base = [b.mask.clone() for b in self.compiled.batches]
        self._takes = [None if b.take is None else
                       torch.as_tensor(b.take, dtype=torch.long, device=dev)
                       for b in self.compiled.batches]
        self._runners: dict = {}
        self.capture_count = 0

    def select(self, predicate) -> "SubproblemView":
        """Choose the active costs (the predicate forms of
        ``Problem.subproblem``); padding stays masked.  Returns self."""
        if self.problem.structure_version != self._structure_version:
            raise ValueError("problem structure changed since this view was compiled; "
                             "build a new SubproblemView")
        masks = self.problem.subset_masks(predicate)
        for b, base, take, m in zip(self.compiled.batches, self._base, self._takes, masks):
            om = torch.as_tensor(m, device=base.device)
            if take is not None:
                om = om[take]
            b.mask.copy_(base & om)
        return self

    def cost(self) -> float:
        """The active subset's cost at the problem's current values."""
        return float(self.compiled.cost(self.problem.stacked_variables()))

    def optimize(self, options: Options = None) -> Result:
        """Optimize the active subset in place on the parent problem: one
        graph runner per ``Options`` value, reset for every later call.
        Spans and counters as :func:`optimize`'s."""
        options = options or Options()
        with profiling.span("nt.optimize"), profiling.setup_record() as setup:
            with profiling.setup_span("nt.setup"):
                t0 = time.perf_counter()
                vars0 = self.problem.stacked_variables()
                runner = self._runners.get(options)
                if runner is None:
                    runner = _GraphRunner(self.compiled, options, vars0)
                    self._runners[options] = runner
                    self.capture_count += bool(runner.graphs)
                else:
                    runner.reset(vars0)
            t1 = time.perf_counter()
            final = runner.run()
            with profiling.span("nt.finish"):
                self.problem.set_values(final["variables"])
                nan = float("nan")
                return _result(final, t0, t1, [nan, nan, nan], _graph_trajectory(final, options),
                               setup)
