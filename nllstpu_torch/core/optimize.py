"""Optimizer entry points: ``compile_problem``, ``run_loop`` and
``optimize`` (port of the Schur Levenberg-Marquardt paths of
``nllstpu/core/optimize.py``: the direct solve, and the implicit one that
``solver="schur_cg"`` asks for and ``solver="schur"`` switches to past the
dense-W limit).

The JAX package compiles the whole outer optimization into one
``lax.while_loop``.  Here the solver state stays on the device and the host
drives the loop, reading a handful of scalars once per damping trial for
the accept and termination decisions.  The control flow is the reference's
(src/optimize.jl:109-180): unconditional adoption of the trial variables,
best-variable snapshot on the first consecutive failure with rollback at
the end, and the termination bitmask.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..ops import fused_obs, schur, schur_reduce, segment_sum
from . import engine, iterators, structs
from .problem import Problem, family_name
from .structs import Options, Result

#: Direct elimination stores W densely; past this size ``solver="schur"``
#: compiles the implicit solve instead, as the JAX package does.
DENSE_W_BYTE_LIMIT = 4 << 30


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The kernel entry points of the Schur paths."""

    assemble: Any  # kernel B1 contract (ops/fused_obs.py), uniform layouts
    assemble_into: Any  # kernel B2 contract, one launch per degree bucket
    reduce: Any  # kernel B3 contract (ops/schur_reduce.py)
    segment_sum: Any  # kernel B6 contract (ops/segment_sum.py), implicit path


#: Dispatchers: the hand-written kernels on CUDA tensors, their plain
#: versions on CPU tensors.
KERNELS = Kernels(
    fused_obs.fused_obs_all, fused_obs.fused_obs_all_into,
    schur_reduce.reduce_s_damped, segment_sum.segment_block_sum,
)
#: The plain PyTorch versions on any device — for measuring the kernels
#: against, never chosen implicitly.
PLAIN = Kernels(
    fused_obs.fused_obs_all_reference, fused_obs.fused_obs_all_into_reference,
    schur_reduce.reduce_s_damped_reference,
    segment_sum.segment_block_sum_reference,
)


@dataclasses.dataclass
class CompiledProblem:
    """A problem lowered onto its device: padded batches and index tables
    uploaded once, the Schur layout fixed."""

    manifolds: dict
    layout: engine.Layout
    batches: list  # device batches (idx/mask/params tensors)
    dtype: Any
    device: Any
    schur_info: schur.SchurInfo
    kernels: Kernels = KERNELS

    def __post_init__(self):
        self._step_index = engine.step_index(self.layout, self.manifolds, self.device)
        self._runs = None if self.schur_info.implicit else [
            (f.e_slot, f.buckets) for f in self.schur_info.fast
        ]

    def cost(self, variables):
        return engine.total_cost(self.batches, variables, runs_list=self._runs)

    def assemble(self, variables):
        if self.schur_info.implicit:
            return schur.assemble_implicit(
                self.batches, variables, self.schur_info, self.dtype,
                segment_sum=self.kernels.segment_sum,
            )
        return schur.assemble_schur(
            self.batches, variables, self.schur_info, self.dtype,
            assemble_kernel=self.kernels.assemble,
            assemble_into_kernel=self.kernels.assemble_into,
        )

    def apply(self, variables, x):
        return engine.apply_step(
            self.manifolds, self._step_index, self.layout.pad, variables, x
        )

    def ctx(self, options: Options = None, phase=None) -> iterators.IterCtx:
        """The iterators' context; ``options.linear_tol`` sets the implicit
        solve's PCG tolerance."""
        si = self.schur_info
        if si.implicit:
            linops = schur.SchurCGOps(
                si.dim_reduced, si.num_elim, si.dof_elim, si.fam_offsets,
                tol=None if options is None else options.linear_tol,
                segment_sum=self.kernels.segment_sum,
            )
        else:
            linops = schur.SchurOps(si.dim_reduced, reduce=self.kernels.reduce)
        extra = {} if phase is None else {"phase": phase}
        return iterators.IterCtx(
            cost=self.cost,
            apply=self.apply,
            dtype=self.dtype,
            linops=linops,
            **extra,
        )


def _device_batch(batch, device, dtype):
    return dataclasses.replace(
        batch,
        idx=tuple(torch.as_tensor(i, dtype=torch.long, device=device) for i in batch.idx),
        params=None if batch.params is None
        else torch.as_tensor(batch.params, dtype=dtype, device=device),
        mask=torch.as_tensor(batch.mask, device=device),
    )


def compile_problem(problem: Problem, solver: str = "schur",
                    schur_family=None, plain: bool = False) -> CompiledProblem:
    """Lower a problem onto its device for a Schur solve: direct
    (``solver="schur"``, or ``"auto"`` with a ``schur_family``) unless its
    dense W would pass :data:`DENSE_W_BYTE_LIMIT`, implicit for
    ``solver="schur_cg"`` or past the limit.  Skewed degree distributions
    get the JAX package's degree relabel (see :func:`schur_layout`); the
    direct path then takes the bucketed layout, assembled by kernel B2.
    ``plain=True`` runs the kernels' plain PyTorch versions on every
    device (a baseline to measure the kernels against)."""
    if solver == "auto" and schur_family is not None:
        solver = "schur"
    if solver not in ("schur", "schur_cg"):
        raise NotImplementedError(
            f"solver={solver!r}: the port has the Schur backends only"
        )
    if schur_family is None:
        raise ValueError(f"solver={solver!r} requires schur_family")
    layout, info, batches = schur_layout(problem, schur_family, solver == "schur_cg")
    schur.check_slice(info, batches)
    if info.implicit:
        schur.upload_implicit(info, problem.device)
    else:
        schur.upload_fast(info, problem.device)
    return CompiledProblem(
        manifolds={n: problem.manifold_of(n) for n in problem.family_names()},
        layout=layout,
        batches=[_device_batch(b, problem.device, problem.dtype) for b in batches],
        dtype=problem.dtype,
        device=problem.device,
        schur_info=info,
        kernels=PLAIN if plain else KERNELS,
    )


def schur_layout(problem: Problem, schur_family, implicit: bool = False):
    """Host half of the Schur compile: ``(layout, info, batches)``.  Skewed
    degree distributions get the degree relabel (``order_key``), exactly
    as in the JAX package.  The direct solve takes the bucketed obs-major
    repack; the implicit one (``implicit``, or a dense W past
    :data:`DENSE_W_BYTE_LIMIT`) batches sorted by landmark."""
    batches = problem.batches()
    counts = schur.elim_degree_counts(batches, problem, schur_family)
    order_key = None
    if counts.size and counts.sum() > 0:
        if counts.size * counts.max() > schur._OBS_MAJOR_MAX_RATIO * counts.sum():
            order_key = {family_name(schur_family): counts}
    layout = engine.build_layout(
        problem, batches=batches, order_last=family_name(schur_family),
        order_key=order_key,
    )
    pre = schur.build_schur_info(problem, layout, schur_family)
    # The JAX package's dense-W size, pad column block included.
    w_bytes = (
        pre.num_elim * (pre.dim_reduced + layout.pad) * pre.dof_elim
        * torch.empty((), dtype=problem.dtype).element_size()
    )
    implicit = implicit or w_bytes > DENSE_W_BYTE_LIMIT
    if implicit:
        batches, buckets = [schur.sort_for_implicit(b, pre) for b in batches], None
    else:
        batches, buckets = schur.repack_batches_for_schur(batches, pre)
    info = schur.build_schur_info(
        problem, layout, schur_family, batches=batches, buckets=buckets,
        implicit=implicit,
    )
    return layout, info, batches


def _termination_bits(cost, dcost, bestcost, maxstep, fails, iternum, opts):
    """The reference's termination bitmask (src/optimize.jl:149-165)."""
    bits = 0
    bits |= int(np.isinf(cost)) << 0
    bits |= int(np.isnan(cost)) << 1
    bits |= int(dcost < bestcost * opts.rel_dcost) << 2
    bits |= int(dcost < opts.abs_dcost) << 3
    bits |= int(np.isinf(maxstep)) << 4
    bits |= int(np.isnan(maxstep)) << 5
    bits |= int(maxstep < opts.dstep) << 6
    bits |= int(fails > opts.max_fails) << 7
    bits |= int(iternum >= opts.max_iters) << 8
    return bits


def run_loop(assemble_fn, cost_fn, ctx: iterators.IterCtx, opts: Options,
             vars0) -> dict:
    """The outer optimization (reference ``optimizeinternal!``) over a dict
    of device tensors.  Returns the final state: ``variables`` (rolled back
    to the best ones when the last iterate is worse), ``startcost``,
    ``bestcost``, ``iternum``, ``converged`` (termination bits), the
    ``ncost``/``ngrad``/``nsolve`` counters and ``trace``, the cost after
    every iteration."""
    t = ctx.np_dtype
    t0 = time.perf_counter()
    with ctx.phase("cost"):
        c0 = t(cost_fn(vars0).item())
    st = dict(
        variables=vars0, varbest=vars0, bestcost=c0, lastcost=c0,
        startcost=c0, itdata=iterators.init_data(t, opts), fails=0,
        iternum=0, converged=0, ncost=1, ngrad=0, nsolve=0, trace=[],
    )
    with np.errstate(all="ignore"):
        while st["converged"] == 0:
            with ctx.phase("assemble"):
                _, sys = assemble_fn(st["variables"])
            nv, c, x, itdata, ns, nc, maxstep = iterators.iterate(
                opts.iterator, ctx, sys, st["variables"], st["bestcost"],
                st["itdata"], opts,
            )
            dcost = st["bestcost"] - c
            accepted = dcost >= 0
            if not accepted and st["fails"] == 0:
                st["varbest"] = st["variables"]
            fails = 0 if accepted else st["fails"] + 1
            bestcost = c if accepted else st["bestcost"]
            iternum = st["iternum"] + 1
            bits = _termination_bits(
                c, dcost if accepted else c, bestcost, maxstep, fails,
                iternum, opts,
            )
            if time.perf_counter() - t0 > opts.max_time:
                bits |= structs.TERM_MAX_TIME
            st.update(
                variables=nv, bestcost=bestcost, lastcost=c, itdata=itdata,
                fails=fails, iternum=iternum, converged=bits,
                ncost=st["ncost"] + nc, ngrad=st["ngrad"] + 1,
                nsolve=st["nsolve"] + ns,
            )
            st["trace"].append(c)
        if not (st["bestcost"] >= st["lastcost"]):
            st["variables"] = st["varbest"]
    return st


def optimize(problem: Problem, options: Options = None) -> Result:
    """Optimize the problem in place on its device and return a
    :class:`Result` (reference ``optimize!``)."""
    options = options or Options()
    t0 = time.perf_counter()
    compiled = compile_problem(
        problem, solver=options.solver, schur_family=options.schur_family
    )
    vars0 = problem.stacked_variables()
    t1 = time.perf_counter()
    final = run_loop(
        compiled.assemble, compiled.cost, compiled.ctx(options), options, vars0
    )
    problem.set_values(final["variables"])
    nan = float("nan")
    return Result(
        start_cost=float(final["startcost"]),
        best_cost=float(final["bestcost"]),
        time_total=time.perf_counter() - t0,
        time_init=t1 - t0,
        time_cost=nan,
        time_gradient=nan,
        time_solver=nan,
        termination=final["converged"],
        num_iterations=final["iternum"],
        cost_computations=final["ncost"],
        gradient_computations=final["ngrad"],
        linear_solves=final["nsolve"],
        costs=[float(c) for c in final["trace"]],
    )
