"""Matrix-free PCG backend (port of ``nllstpu/ops/cg.py``): the linear
system of problems whose variable-cost graph is sparse but not bipartite
(pose graphs, meshes), where a dense H wastes memory and no landmark family
can be eliminated.  ``solver="cg"`` (or ``"pcg"``, or ``"auto"`` where the
JAX package keeps its "cg") compiles it.

H is never formed.  The assembly keeps every batch's per-cost blocks
(``engine.batch_grad_hess``) as they are, and H·x is computed from them:
gather x at each cost's rows, the per-cost block product, then the
per-variable sums.  Those sums, and the gradient's, the diagonal's and the
block-Jacobi blocks', go through kernel B6 (``segment_sum.py``) in an
order fixed at compile time (:class:`CGOps`' families: every (cost, slot)
contribution of a family sorted by its variable, across batches, as
``engine.dense_plan`` sorts H's targets), so that two matvecs, and two
assemblies, give the same bits, which a scatter-add does not promise.  A
family's unfixed variables fill one range of the tangent vector in order
(``engine.build_layout``), so the sums are written by concatenation, and
the preconditioner reads its rows by a view: no index table is read on the
host after compile time, and every piece can be captured in a CUDA graph.

The JAX package's per-variable key tables (``_slot_key_table``,
``_CG_MAX_K``, its scatter-add fallback) and the preconditioner's
contiguous fast path work around XLA's serialized scatters on the TPU; they
are not carried over.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import engine
from ..core.linearsolver import batched_inv_spd, pcg_chunk, pcg_start
from ..core.problem import family_name
from .segment_sum import segment_block_sum

#: PCG iteration cap per solve (the JAX package's ``CGOps.max_iters``).
CG_MAX_ITERS = 2000


@dataclasses.dataclass(frozen=True, eq=False)
class CGFamily:
    """One family's contributions in compile-time order: its ``n`` unfixed
    variables fill tangent rows ``[base, base + n·dof)``; ``slots`` lists,
    per batch that touches the family, ``(batch index, slot starts)`` (the
    block columns of the family's slots); the contributions, batch by
    batch, cost-major then slot, are taken in the order ``perm`` (the real
    costs on unfixed variables, sorted by variable, stably) and summed in
    runs ``starts [n + 1]`` (an empty run, a variable no cost touches, sums
    to zero)."""

    dof: int
    base: int
    n: int
    slots: tuple
    perm: Any
    starts: Any


def _block_mv(h, x):
    """``[B, S, S] · [B, S] → [B, S]`` by elementwise products and a sum,
    not a matmul: no TF32, whatever ``torch.backends.cuda.matmul.
    allow_tf32`` says (a reduced-precision product makes the matvec
    non-symmetric and CG diverges, as the JAX package notes of the TPU's
    bf16 matmul), and one fixed summation order."""
    return (h * x[:, None, :]).sum(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class CGOps:
    """Linear-system ops over ``sys = (b, hs, rows, pre_blocks, diag)``
    (the JAX package's ``CGOps``): the gradient ``b [d]``, every batch's
    per-cost blocks ``hs`` (``[B, S, S]``) and their tangent rows ``rows``
    (``[B, S]``, the dustbin past ``dim``), the block-Jacobi blocks per
    family (``[n, dof, dof]``, in :attr:`families`' order) and H's
    diagonal.  The same protocol as ``DenseOps`` and ``SchurCGOps``, with
    the graph driver's PCG pieces under ``SchurCGOps``' contract.

    ``tol`` (``Options.linear_tol``) None means 1e-5 in float32 and 1e-14
    in float64, and a solve stops after :data:`CG_MAX_ITERS`: the JAX
    package's defaults (not ``SchurCGOps``').  ``segment_sum`` is kernel B6's dispatcher or its
    plain version.  B6 refuses L·D ≥ 2³¹; at the parking-garage pose
    graph's size the widest call sums 12,546 slot blocks of 36 values into
    1,660 × 36 outputs.  Every :meth:`solve` (and every graph-driver solve)
    appends its PCG iterations to ``cg_iters``."""

    dim: int
    pad: int
    rows: tuple  # per batch [B, S] long device tensors (engine.batch_rows)
    families: tuple  # CGFamily, in tangent order, covering [0, dim)
    tol: Optional[float] = None
    segment_sum: Callable = segment_block_sum
    cg_iters: list = dataclasses.field(default_factory=list)

    def _tol(self, dtype):
        if self.tol is not None:
            return self.tol
        return 1e-5 if dtype == torch.float32 else 1e-14

    def sums(self, per_batch, blocks: bool = False):
        """Per family, the per-variable sums ``[n, dof]`` of ``per_batch[i]``
        (``[B, S]``), or with ``blocks`` ``[n, dof²]`` of each slot's
        diagonal block of ``per_batch[i]`` (``[B, S, S]``), in compile-time
        order through ``segment_sum``."""
        out = []
        for f in self.families:
            w = f.dof * f.dof if blocks else f.dof
            parts = []
            for bi, starts in f.slots:
                t = per_batch[bi]
                if not blocks:
                    cols = [t[:, c : c + f.dof] for c in starts]
                else:
                    cols = [t[:, c : c + f.dof, c : c + f.dof].reshape(-1, w) for c in starts]
                parts.append((cols[0] if len(cols) == 1 else torch.stack(cols, 1)).reshape(-1, w))
            if not parts:
                out.append(per_batch[0].new_zeros(f.n, w))
                continue
            v = parts[0] if len(parts) == 1 else torch.cat(parts)
            out.append(self.segment_sum(v.index_select(0, f.perm), f.starts))
        return out

    def vector(self, per_batch):
        """The ``[dim]`` vector of the per-variable sums of ``per_batch``."""
        parts = [s.reshape(-1) for s in self.sums(per_batch)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def grad(self, sys):
        return sys[0]

    def diag_max(self, sys):
        return sys[4].abs().max()

    def hx(self, sys, x):
        """H·x without forming H: x gathered at each cost's rows (the
        dustbin reads zeros), the per-cost block products, the
        per-variable sums."""
        _, hs, rows, _, _ = sys
        xp = torch.cat([x, x.new_zeros(self.pad)])
        return self.vector([_block_mv(h, xp[r]) for h, r in zip(hs, rows)])

    def matvec(self, sys, lam, x):
        """(H + λI)·x."""
        return self.hx(sys, x) + lam * x

    def quad(self, sys, x):
        """xᵀHx of the undamped system."""
        return x @ self.hx(sys, x)

    def precond_inverses(self, sys, lam):
        """The block-Jacobi preconditioner: per family, the inverses of
        the damped diagonal blocks ``blocks + λI``."""
        out = []
        for f, blocks in zip(self.families, sys[3]):
            eye = torch.eye(f.dof, dtype=blocks.dtype, device=blocks.device)
            out.append(batched_inv_spd(blocks + lam * eye))
        return tuple(out)

    def _precond(self, inv, r):
        parts = [
            _block_mv(i, r[f.base : f.base + f.n * f.dof].view(f.n, f.dof)).reshape(-1)
            for f, i in zip(self.families, inv)
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def pcg_setup(self, sys, lam):
        """The PCG's set-up at ``lam`` (a float or a 0-d tensor), under
        ``SchurCGOps.pcg_setup``'s contract: ``(None, inv, tol2, state)``
        (no damped inverses: nothing is eliminated)."""
        b = sys[0]
        inv = self.precond_inverses(sys, lam)
        tol2, state = pcg_start(b, functools.partial(self._precond, inv), self._tol(b.dtype))
        return None, inv, tol2, state

    def pcg_chunk(self, sys, lam, h_inv, inv, tol2, state):
        """``linearsolver.CG_CHECK_EVERY`` PCG iterations from ``state``
        over :meth:`matvec`, capped at :data:`CG_MAX_ITERS`: ``(state, [more,
        iterations])``, on the device."""
        return pcg_chunk(functools.partial(self.matvec, sys, lam),
                         functools.partial(self._precond, inv), tol2, state, CG_MAX_ITERS)

    def pcg_finish(self, sys, h_inv, state):
        """The step: the PCG's solution itself."""
        return state[0]

    def solve(self, sys, lam):
        """x with (H + λI) x = g: :meth:`pcg_setup`, :meth:`pcg_chunk`
        until converged (the host reads the flag after every chunk),
        :meth:`pcg_finish`."""
        h_inv, inv, tol2, state = self.pcg_setup(sys, lam)
        more = True
        while more:
            state, flag = self.pcg_chunk(sys, lam, h_inv, inv, tol2, state)
            more, iters = flag.tolist()
        self.cg_iters.append(int(iters))
        return self.pcg_finish(sys, h_inv, state)


def build_cg_ops(batches, layout: engine.Layout, manifolds: dict, device,
                 segment_sum=segment_block_sum) -> CGOps:
    """The :class:`CGOps` of host ``batches`` under ``layout``: each
    family's contribution order and runs, and every batch's rows, on
    ``device``."""
    d = layout.dof_total
    rows = [engine.batch_rows(b, layout) for b in batches]
    families = []
    for name, off in layout.offsets.items():
        dof = manifolds[name].dof
        off = np.asarray(off)
        held = np.sort(off[off < d])
        if held.size == 0:
            continue
        base = int(held[0])
        if not np.array_equal(held, base + dof * np.arange(held.size)):
            raise ValueError(f"family {name}: its unfixed variables do not fill one range")
        slots, targets = [], []
        for bi, b in enumerate(batches):
            mask = np.asarray(b.mask)
            first, cols, c = [], [], 0
            for man, idx in zip(b.manifolds, b.idx):
                if family_name(man) == name:
                    first.append(c)
                    o = off[np.asarray(idx)]
                    cols.append(np.where(mask & (o < d), (o - base) // dof, -1))
                c += man.dof
            if first:
                slots.append((bi, tuple(first)))
                targets.append(np.stack(cols, 1).reshape(-1))
        t = np.concatenate(targets) if targets else np.zeros(0, np.int64)
        keep = np.nonzero(t >= 0)[0]
        perm = keep[np.argsort(t[keep], kind="stable")]
        starts = np.r_[0, np.cumsum(np.bincount(t[keep], minlength=held.size))]
        families.append(CGFamily(
            dof, base, int(held.size), tuple(slots),
            torch.as_tensor(perm, dtype=torch.long, device=device),
            torch.as_tensor(starts, dtype=torch.long, device=device),
        ))
    families.sort(key=lambda f: f.base)
    if sum(f.n * f.dof for f in families) != d:
        raise ValueError("the families' ranges do not cover the tangent space")
    return CGOps(
        dim=d,
        pad=layout.pad,
        rows=tuple(torch.as_tensor(r, dtype=torch.long, device=device) for r in rows),
        families=tuple(families),
        segment_sum=segment_sum,
    )


def assemble_cg(batches, variables: dict, ops: CGOps):
    """``(cost, (b, hs, rows, pre_blocks, diag))`` (the JAX package's
    ``assemble_cg``): the cost; the gradient, the diagonal and the
    block-Jacobi blocks, each summed per variable through ``ops.sums``;
    every batch's per-cost blocks and rows, unscattered.  Fixed variables
    and padding costs are dropped, not sent to a dustbin block."""
    total, gs, hs = None, [], []
    for b in batches:
        c, g, h = engine.batch_grad_hess(b, variables)
        total = c if total is None else total + c
        gs.append(g)
        hs.append(h)
    diag = ops.vector([torch.diagonal(h, dim1=-2, dim2=-1) for h in hs])
    pre = tuple(
        s.view(f.n, f.dof, f.dof) for f, s in zip(ops.families, ops.sums(hs, blocks=True))
    )
    return total, (ops.vector(gs), tuple(hs), ops.rows, pre, diag)
