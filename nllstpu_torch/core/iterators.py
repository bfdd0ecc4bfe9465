"""Per-iteration step algorithm: Levenberg-Marquardt (port of
``nllstpu/core/iterators.py:_levmar``).

The JAX package runs the damping retry as a ``lax.while_loop`` on the
device.  Here the tensors stay on the device and the host reads five
scalars per damping trial (trial cost, max |step|, gᵀx, xᵀx and whether
the reduced system's Cholesky held) in ONE transfer, then does the scalar
control in numpy scalars of the problem's dtype, so float32 problems round
λ and the step quality as the JAX package's float32 programs do.  The
trial itself is the context's (:meth:`IterCtx.trial`): run eagerly here,
replayed from CUDA graphs by the graph driver
(``core/optimize.py:_GraphRunner``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from . import structs


def _no_phase(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class IterCtx:
    """What the iterators need: full-cost evaluation, manifold step
    application, the linear-system ops and the damped trial built on
    them.  ``phase(name)`` returns a context manager around each phase
    ("assemble", "solve", "cost") — a hook for device timers; it does
    nothing by default."""

    cost: Callable  # vars -> scalar tensor
    apply: Callable  # (vars, x) -> vars
    dtype: Any  # torch dtype
    linops: Any
    phase: Callable = _no_phase

    @property
    def np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def grad(self, sys):
        return self.linops.grad(sys)

    def trial(self, sys, g, variables, lam, lu: bool = False):
        """One damped trial at ``lam`` (a numpy scalar): the step x of
        (H + λI) x = −g, the variables it gives and their cost.  Returns
        ``(new_vars, x, [cost, max|x|, gᵀx, xᵀx, ok])``, the five scalars
        read in one transfer; ``ok`` is false when the reduced system's
        Cholesky failed and the caller must take the trial again with
        ``lu``.  Here the solve falls back to LU itself
        (``linearsolver.cholesky_solve``), so ``ok`` is always 1."""
        lam_t = torch.full((), float(lam), dtype=torch.float64, device=g.device)
        with self.phase("solve"):
            x = -self.linops.solve(sys, lam_t)
        with self.phase("cost"):
            nv = self.apply(variables, x)
            c = self.cost(nv)
        read = torch.stack([c, x.abs().max(), g @ x, x @ x, torch.ones_like(c)]).tolist()
        return nv, x, read


def init_data(np_dtype, opts):
    """Initial iterator scalars (reference ``reset!``: λ = 0 means auto)."""
    return {"lm_lambda": np_dtype(opts.init_lm_lambda)}


def iterate(name: str, ctx: IterCtx, sys, variables, bestcost, data, opts):
    """One outer iteration.  Returns ``(new_vars, new_cost, applied_step,
    new_data, n_solves, n_cost_evals, max|step|, |step|²)``; costs are
    host scalars."""
    if name == structs.LEVENBERG_MARQUARDT:
        return _levmar(ctx, sys, variables, bestcost, data, opts)
    if name in structs.ITERATORS:
        raise NotImplementedError(
            f"iterator {name!r} is not ported yet (Levenberg-Marquardt only)"
        )
    raise ValueError(f"unknown iterator {name!r}")


def _levmar(ctx, sys, variables, bestcost, data, opts):
    """Levenberg-Marquardt with the reference's damping schedule
    (src/iterators.jl:139-172): λ starts at 1e-6·max|diag H|, a rejected
    trial multiplies λ by µ (µ doubling), and an accepted one scales λ by
    ``ρ < 0.983 ? 1 − (2ρ−1)³ : 0.1`` with ρ the step quality against the
    undamped quadratic model, 0.5·(gᵀx − λ|x|²) for the damped solve.  A
    non-finite trial cost is a rejected trial; a NaN step ends the retry.
    A trial whose Cholesky failed is taken again through LU before the
    accept test, and counts as one solve."""
    t = ctx.np_dtype
    g = ctx.grad(sys)
    lam = t(data["lm_lambda"])
    if lam == 0:
        lam = t(ctx.linops.diag_max(sys).item()) * t(1e-6)
    mu = t(2.0)
    ns = nc = 0
    with np.errstate(all="ignore"):
        while True:
            nv, x, read = ctx.trial(sys, g, variables, lam)
            if not read[4]:
                nv, x, read = ctx.trial(sys, g, variables, lam, lu=True)
            c, maxstep, gx, xx = (t(v) for v in read[:4])
            ns += 1
            nc += 1
            if (
                ((not (c > bestcost)) and np.isfinite(c))
                or maxstep < opts.dstep
                or np.isnan(maxstep)
            ):
                break
            lam = lam * mu
            mu = mu * t(2)
        quality = (c - bestcost) / (t(0.5) * (gx - lam * xx))
        factor = t(1) - (t(2) * quality - t(1)) ** 3 if quality < 0.983 else t(0.1)
        lam_new = lam * factor
    return nv, c, x, dict(data, lm_lambda=lam_new), ns, nc, maxstep, xx
