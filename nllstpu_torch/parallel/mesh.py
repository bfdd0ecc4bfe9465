"""Data-parallel execution: cost batches split over the ranks of a
process group, the assembled system summed by ``all_reduce`` (port of
``nllstpu/parallel/mesh.py``).

Every rank computes the cost, gradient and Hessian contributions of its
rows of every batch, and the normal equations are summed over the ranks
so that the solve runs replicated.  This holds for the dense backend and
for the direct Schur backend, whose system is summed blockwise, W
included: every rank holds the whole W here (the landmark-sharded path,
:mod:`.schur_shard`, is the one that divides it).

:class:`Mesh` is the port's counterpart of the JAX package's 1-D ``data``
mesh: the process group, this process's rank, the group's size and the
rank's device.  Its :meth:`Mesh.all_reduce` is the one collective of the
sharded paths: where the JAX package gathers, the port places the rank's
chunk into zeros and sums, as the JAX package's ``_gather_elim_chunks``
does, so that ``nccl`` and ``gloo`` on CUDA tensors both serve.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..core import engine, optimize
from ..ops import schur

DATA_AXIS = "data"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """The ranks of one process group as the sharded paths see them:
    ``group`` (None for a mesh of one rank, which reduces nothing),
    ``rank``, ``size`` and ``device``, this rank's device.  ``collectives``
    counts the ``all_reduce`` calls; under :meth:`timed` each is timed
    (CUDA events on the card, the host clock on the CPU)."""

    def __init__(self, group, rank: int, size: int, device):
        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)
        self.collectives = 0
        self._spans = None

    def all_reduce(self, *parts, op: str = "sum"):
        """The sum (``op="max"``: the maximum) over the ranks of each of
        ``parts``, tensors of one dtype, in ONE collective over their
        concatenation; returns one tensor or a tuple, as given.  The parts
        are not modified."""
        if self.size == 1:
            return parts if len(parts) > 1 else parts[0]
        flat = torch.cat([p.reshape(-1) for p in parts])
        self.collectives += 1
        if self._spans is None:
            dist.all_reduce(flat, op=_OPS[op], group=self.group)
        elif self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dist.all_reduce(flat, op=_OPS[op], group=self.group)
            end.record()
            self._spans.append((start, end))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(flat, op=_OPS[op], group=self.group)
            self._spans.append(time.perf_counter() - t0)
        out = [v.view(p.shape) for v, p in zip(flat.split([p.numel() for p in parts]), parts)]
        return tuple(out) if len(out) > 1 else out[0]

    @contextlib.contextmanager
    def timed(self):
        """Time every collective inside: yields a list that, on exit, holds
        the seconds of each (read after the device's work is done)."""
        self._spans, seconds = [], []
        try:
            yield seconds
        finally:
            spans, self._spans = self._spans, None
            if spans and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                seconds.extend(s.elapsed_time(e) * 1e-3 for s, e in spans)
            else:
                seconds.extend(spans)


def make_mesh(n_devices: int = None, device=None) -> Mesh:
    """The mesh of this process: its rank in the default process group
    (``distributed.initialize``) and the group's size, or one rank without
    a group.  ``n_devices``, when given, must be that size (one process per
    rank).  ``device``: the rank's device, by default the card
    ``cuda:(rank % torch.cuda.device_count())`` (no card raises, as every
    entry point of the port does); ``"cpu"`` for the CPU, which ``nccl``
    refuses."""
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_mesh({n_devices}): this process's group has {size} rank(s); the port runs "
            "one process per rank (distributed.initialize)"
        )
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = resolve_device(device)
    if group is not None and dist.get_backend() == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend 'nccl' runs on the cards, not on {device}; use 'gloo'")
        torch.cuda.set_device(device)
    return Mesh(group, rank, size, device)


def _host_batch(batch):
    """A compiled (device) batch's arrays back on the host, as numpy."""
    def host(t):
        return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    return dataclasses.replace(
        batch,
        idx=tuple(host(i) for i in batch.idx),
        params=None if batch.params is None else host(batch.params),
        mask=host(batch.mask),
    )


def _repad_batch(batch, multiple: int):
    """The host batch padded (mask False) so that its length divides
    ``multiple``."""
    b = batch.mask.shape[0]
    extra = -(-b // multiple) * multiple - b
    if extra == 0:
        return batch

    def pad(a):
        return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1))

    take = np.arange(b) if batch.take is None else np.asarray(batch.take)
    return dataclasses.replace(
        batch,
        idx=tuple(pad(i) for i in batch.idx),
        params=None if batch.params is None else pad(batch.params),
        mask=pad(batch.mask),
        take=pad(take),
    )


def _rank_rows(batch, n: int, rank: int):
    """Rank ``rank``'s contiguous block of the host batch's rows, the batch
    repadded to a multiple of ``n`` first."""
    b = _repad_batch(batch, n)
    per = b.mask.shape[0] // n
    sl = slice(rank * per, (rank + 1) * per)
    take = np.arange(b.mask.shape[0]) if b.take is None else np.asarray(b.take)
    return dataclasses.replace(
        b,
        idx=tuple(i[sl] for i in b.idx),
        params=None if b.params is None else b.params[sl],
        mask=b.mask[sl],
        n=int(b.mask[sl].sum()),
        take=take[sl],
    )


@dataclasses.dataclass
class ParallelCompiled:
    """A compiled problem whose ``cost`` and ``assemble`` sum over the
    ranks: ``local`` is this rank's :class:`CompiledProblem` over its rows
    of every batch, its system summed by one ``all_reduce``; the solve is
    ``base``'s, replicated."""

    base: optimize.CompiledProblem
    mesh: Mesh
    local: optimize.CompiledProblem

    @property
    def device(self):
        return self.base.device

    def cost(self, variables):
        return self.mesh.all_reduce(self.local.cost(variables))

    def assemble(self, variables):
        c, sys = self.local.assemble(variables)
        c, *sys = self.mesh.all_reduce(c, *sys)
        return c, tuple(sys)

    def apply(self, variables, x):
        return self.base.apply(variables, x)

    def ctx(self, options=None, phase=None):
        return dataclasses.replace(self.base.ctx(options, phase=phase), cost=self.cost)

    def run(self, vars0, opts):
        """The optimization over the summed system (the JAX package's
        ``run_loop_jit``): the stepped driver's loop (``run_stepped``),
        the same on every rank.  Returns ``run_loop``'s final state."""
        return optimize.run_stepped(self, opts, vars0)


def parallelize(compiled: optimize.CompiledProblem, mesh: Mesh) -> ParallelCompiled:
    """Split a compiled problem's cost batches over ``mesh``'s ranks: rank
    r takes the r-th contiguous block of every batch's rows.  The dense
    backend sums ``(c, H, g)``; the direct Schur backend ``(c, a_rr, b_r,
    h_ll, g_l, W)``, every rank's W in the one ``[L, dl, Dr]`` layout, its
    rows routed as the port routes any batch (``schur.route_batches``:
    obs-major where the rank's rows qualify, the generic route
    otherwise)."""
    info = compiled.schur_info
    if info is not None and info.implicit:
        # Summing the implicit system's per-cost coupling blocks across
        # ranks would be silently wrong; the landmark-sharded path takes it.
        raise ValueError(
            "parallelize() does not support the implicit (schur_cg) "
            "backend; use parallel.schur_shard.parallelize_schur / "
            "optimize_sharded"
        )
    if compiled.cg_ops is not None:
        raise ValueError("parallelize() sums the dense or the direct Schur system; the cg "
                         "backend keeps per-cost blocks (compile with solver='dense')")
    if compiled.device != mesh.device:
        raise ValueError(f"the problem lives on {compiled.device}, this rank's mesh on "
                         f"{mesh.device}")
    layout, device, dtype = compiled.layout, compiled.device, compiled.dtype
    rows = [_rank_rows(_host_batch(b), mesh.size, mesh.rank) for b in compiled.batches]
    plan = None
    if info is None:
        plan = engine.dense_plan(rows, layout, device)
    else:
        info = schur.SchurInfo(
            elim_family=info.elim_family, dim_reduced=info.dim_reduced,
            num_elim=info.num_elim, dof_elim=info.dof_elim, elim_ids=info.elim_ids,
            fams=info.fams,
        )
        rows, buckets, route = schur.route_batches(rows, info, layout, dtype)
        schur.fill_tables(info, layout, rows, buckets, route)
        schur.upload_tables(info, device, dtype)
    local = optimize.CompiledProblem(
        manifolds=compiled.manifolds, layout=layout,
        batches=[engine.device_batch(b, device, dtype) for b in rows], dtype=dtype,
        device=device, schur_info=info, kernels=compiled.kernels, dense_plan=plan,
    )
    return ParallelCompiled(base=compiled, mesh=mesh, local=local)
