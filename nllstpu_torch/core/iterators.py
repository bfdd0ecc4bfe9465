"""Per-iteration step algorithms: Newton, Levenberg-Marquardt, dogleg and
gradient descent (port of ``nllstpu/core/iterators.py``), and the dense
linear-system operations :class:`DenseOps`.

The JAX package runs each retry loop (LM's damping, dogleg's trust region,
gradient descent's line search) as a ``lax.while_loop`` on the device.
Here the tensors stay on the device and the host reads a handful of
scalars per trial in ONE transfer, then does the scalar control in numpy
scalars of the problem's dtype, so float32 problems round λ, the trust
radius and the step size as the JAX package's float32 programs do.  The
control's arithmetic is ``core/rules.py``'s, shared with
``optimize_singles``' per-lane loop.

Every trial is one of two shapes, each the context's (:class:`IterCtx`):

- the damped trial (:meth:`IterCtx.trial`): x = −(H + λI)⁻¹g, read
  ``[cost, max|x|, gᵀx, xᵀx, ok]``; LM, and Newton at λ = 0;
- the combination trial (:meth:`IterCtx.combo`): x from the gradient and
  the Newton leg, read the same five scalars.  Within one dogleg
  iteration every step is a combination of the Cauchy point c = −(gᵀg /
  gᵀHg)·g and the Newton leg x_n (``"cauchy"``: s·c; ``"newton"``: x_n;
  ``"blend"``: (x_n − c)·s + c); every gradient-descent step is
  ``"gradient"``: −g·s.

Dogleg's leg (:meth:`IterCtx.leg`) solves at λ = 0 and forms gᵀHg once
per iteration, and reads ``[gᵀg, gᵀHg, x_nᵀx_n, |x_n − c|², cᵀ(x_n − c),
ok]``: every scalar of the trust-region control follows from them.  A
solve whose Cholesky failed (``ok`` false) is taken again through LU.  The
context runs the pieces eagerly here; the graph driver
(``core/optimize.py:_GraphRunner``) replays them from CUDA graphs, writing
λ or s into device memory before each replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from . import rules, structs
from .linearsolver import cholesky_solve, cholesky_solve_ex, lu_solve

#: The combination trials' step forms (see the module docstring).
COMBOS = ("cauchy", "newton", "blend", "gradient")


def _no_phase(name: str):
    return contextlib.nullcontext()


def _as_dtype(lam, a):
    """λ (a float or a 0-d tensor) in ``a``'s dtype and device."""
    if torch.is_tensor(lam):
        return lam.to(device=a.device, dtype=a.dtype)
    return torch.full((), float(lam), dtype=a.dtype, device=a.device)


@dataclasses.dataclass(frozen=True)
class DenseOps:
    """Linear-system operations over a dense ``sys = (H, g)`` pair (the JAX
    package's ``DenseOps``), with the capture-safe solve of the Schur
    backends (:meth:`solve_ex`)."""

    dim: int

    @staticmethod
    def _damped(a, lam):
        """H + λI: λ added to a copy's diagonal (the off-diagonal entries
        are H's own, as in H + λ·I)."""
        m = a.clone()
        m.diagonal().add_(_as_dtype(lam, a))
        return m

    def solve(self, sys, lam):
        """x with (H + λI) x = g: Cholesky, LU where it fails."""
        a, b = sys
        return cholesky_solve(self._damped(a, lam), b)

    def solve_ex(self, sys, lam, lu: bool = False):
        """``(x, ok)`` without a host sync (``SchurOps.solve_ex``'s
        contract)."""
        a, b = sys
        m = self._damped(a, lam)
        return (lu_solve(m, b), None) if lu else cholesky_solve_ex(m, b)

    def grad(self, sys):
        return sys[1]

    def quad(self, sys, x):
        """xᵀHx (the reference's ``fast_bAb``)."""
        return x @ (sys[0] @ x)

    def diag_max(self, sys):
        return torch.diagonal(sys[0]).abs().max()

    def leg_ex(self, sys, lam0, lu: bool = False):
        """``(x, gᵀHg, ok)``: the undamped solve H x = g (``lam0`` a zero λ)
        and the gradient's curvature."""
        x, ok = self.solve_ex(sys, lam0, lu)
        return x, self.quad(sys, sys[1]), ok


def leg_tensors(g, xsol, ghg, ok):
    """Dogleg's leg from the undamped solve ``xsol`` and gᵀHg: ``(x_n,
    cauchy, read)`` with read ``[gᵀg, gᵀHg, x_nᵀx_n, |x_n − c|², cᵀ(x_n −
    c), ok]``, the JAX package's expressions in the problem's dtype."""
    tiny = torch.finfo(g.dtype).tiny
    gnorm2 = g @ g
    coef = gnorm2 / (ghg + tiny)
    cauchy = -coef * g
    xn = -xsol
    d = xn - cauchy
    ok = torch.ones_like(gnorm2) if ok is None else ok.to(g.dtype)
    return xn, cauchy, torch.stack([gnorm2, ghg, xn @ xn, d @ d, cauchy @ d, ok])


def combo_step(kind, g, legs, s):
    """The step of a combination trial (``kind`` one of :data:`COMBOS`,
    ``s`` a 0-d tensor in g's dtype, ``legs = (x_n, cauchy)``)."""
    if kind == "gradient":
        return -g * s
    xn, cauchy = legs
    if kind == "cauchy":
        return s * cauchy
    if kind == "newton":
        return xn
    return (xn - cauchy) * s + cauchy


def trial_read(cost, x, g, ok=None):
    """The five scalars of a trial, stacked: ``[cost, max|x|, gᵀx, xᵀx,
    ok]``."""
    ok = torch.ones_like(cost) if ok is None else ok.to(cost.dtype)
    return torch.stack([cost, x.abs().max(), g @ x, x @ x, ok])


@dataclasses.dataclass(frozen=True)
class IterCtx:
    """What the iterators need: full-cost evaluation, manifold step
    application, the linear-system ops and the trials built on them.
    ``phase(name)`` returns a context manager around each phase
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

    def _finish(self, variables, x, g, ok=None):
        with self.phase("cost"):
            nv = self.apply(variables, x)
            c = self.cost(nv)
        return nv, x, trial_read(c, x, g, ok).tolist()

    def trial(self, sys, g, variables, lam, lu: bool = False):
        """One damped trial at ``lam`` (a numpy scalar): the step x of
        (H + λI) x = −g, the variables it gives and their cost.  Returns
        ``(new_vars, x, [cost, max|x|, gᵀx, xᵀx, ok])``, the five scalars
        read in one transfer; ``ok`` is false when the system's Cholesky
        failed and the caller must take the trial again with ``lu``.  Here
        the solve falls back to LU itself (``linearsolver.cholesky_solve``),
        so ``ok`` is always 1."""
        lam_t = torch.full((), float(lam), dtype=torch.float64, device=g.device)
        with self.phase("solve"):
            x = -self.linops.solve(sys, lam_t)
        return self._finish(variables, x, g)

    def leg(self, sys, g, lu: bool = False):
        """Dogleg's Newton leg and gradient curvature: ``(legs, read)``
        (:func:`leg_tensors`).  Through the backend's ``leg_ex`` (the
        Cholesky's flag in ``ok``; with ``lu`` the LU solve), else the PCG
        solve at λ = 0 and ``quad``."""
        zero = torch.zeros((), dtype=torch.float64, device=g.device)
        with self.phase("solve"):
            if hasattr(self.linops, "leg_ex"):
                xsol, ghg, ok = self.linops.leg_ex(sys, zero, lu)
            else:
                xsol, ok = self.linops.solve(sys, zero), None
                ghg = self.linops.quad(sys, g)
            xn, cauchy, read = leg_tensors(g, xsol, ghg, ok)
        return (xn, cauchy), read.tolist()

    def combo(self, sys, g, variables, legs, kind, s):
        """One combination trial (:func:`combo_step`; ``s`` a numpy
        scalar): ``(new_vars, x, [cost, max|x|, gᵀx, xᵀx, 1])``."""
        x = combo_step(kind, g, legs, torch.full((), float(s), dtype=g.dtype, device=g.device))
        return self._finish(variables, x, g)


def init_data(np_dtype, opts):
    """Initial iterator scalars (reference ``reset!``: λ = 0 and trust
    radius 0 mean auto, step size 1; overridable through Options)."""
    return {
        "lm_lambda": np_dtype(opts.init_lm_lambda),
        "tr": np_dtype(opts.init_trust_radius),
        "gd_step": np_dtype(opts.init_gd_step),
    }


def iterate(name: str, ctx: IterCtx, sys, variables, bestcost, data, opts):
    """One outer iteration.  Returns ``(new_vars, new_cost, applied_step,
    new_data, n_solves, n_cost_evals, max|step|, |step|²)``; costs are
    host scalars."""
    if name == structs.NEWTON:
        return _newton(ctx, sys, variables, bestcost, data, opts)
    if name == structs.LEVENBERG_MARQUARDT:
        return _levmar(ctx, sys, variables, bestcost, data, opts)
    if name == structs.DOGLEG:
        return _dogleg(ctx, sys, variables, bestcost, data, opts)
    if name == structs.GRADIENT_DESCENT:
        return _gradient_descent(ctx, sys, variables, bestcost, data, opts)
    raise ValueError(f"unknown iterator {name!r}")


def _damped_trial(ctx, sys, g, variables, lam):
    """A damped trial, taken again through LU when its Cholesky failed."""
    nv, x, read = ctx.trial(sys, g, variables, lam)
    if not read[4]:
        nv, x, read = ctx.trial(sys, g, variables, lam, lu=True)
    return nv, x, read


def _newton(ctx, sys, variables, bestcost, data, opts):
    """Undamped Newton step (src/iterators.jl:16-27): the damped trial at
    λ = 0; one solve, one cost."""
    t = ctx.np_dtype
    g = ctx.grad(sys)
    nv, x, read = _damped_trial(ctx, sys, g, variables, t(0))
    c, maxstep, _, xx = (t(v) for v in read[:4])
    return nv, c, x, data, 1, 1, maxstep, xx


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
    if lam == 0:  # read max|diag H| only when it is needed
        lam = rules.lm_start(lam, t(ctx.linops.diag_max(sys).item()))
    mu = t(2.0)
    ns = nc = 0
    with np.errstate(all="ignore"):
        while True:
            nv, x, read = _damped_trial(ctx, sys, g, variables, lam)
            c, maxstep, gx, xx = (t(v) for v in read[:4])
            ns += 1
            nc += 1
            if rules.accepts(c, bestcost, maxstep, opts.dstep):
                break
            lam, mu = rules.lm_reject(lam, mu)
        lam_new = rules.lm_accept(lam, c, bestcost, gx, xx)
    return nv, c, x, dict(data, lm_lambda=lam_new), ns, nc, maxstep, xx


def _dogleg(ctx, sys, variables, bestcost, data, opts):
    """Dogleg trust region (src/iterators.jl:47-115, the JAX package's
    jit form): the Cauchy leg, the full Newton leg, or the trust-circle
    intersection of the Cauchy→Newton segment, with the ×3 / ×0.5 radius
    updates at quality 0.375 / 0.125 and a halved radius after a
    non-finite trial.  The leg is one solve; each trial one cost."""
    t = ctx.np_dtype
    tiny = np.finfo(t).tiny
    g = ctx.grad(sys)
    legs, read = ctx.leg(sys, g)
    if not read[5]:
        legs, read = ctx.leg(sys, g, lu=True)
    gnorm2, ghg, xnxn, sq_leg, cdot = (t(v) for v in read[:5])
    with np.errstate(all="ignore"):
        coef, alpha2, alpha = rules.dogleg_leg(gnorm2, ghg, tiny)
        tr = t(data["tr"])
        if tr == 0:
            tr = alpha  # first step: the Cauchy point
        beta = np.sqrt(xnxn)
        c_prev = bestcost
        nc = 0
        while True:
            first, full, s, lin = rules.dogleg_point(tr, coef, alpha2, alpha, beta, gnorm2,
                                                     cdot, sq_leg, c_prev, tiny)
            kind = "cauchy" if first else "newton" if full else "blend"
            nv, x, read = ctx.combo(sys, g, variables, legs, kind, s)
            c, maxstep, _, xx = (t(v) for v in read[:4])
            nc += 1
            tr = rules.dogleg_radius(tr, bestcost, c, lin, xx)
            if rules.accepts(c, bestcost, maxstep, opts.dstep):
                break
            c_prev = c
    return nv, c, x, dict(data, tr=tr), 1, nc, maxstep, xx


def _gradient_descent(ctx, sys, variables, bestcost, data, opts):
    """Gradient descent with the reference's quadratic-fit line search
    (src/iterators.jl:186-208): a rejected step of size s is refitted to
    s·½·gᵀx / (best + gᵀx − cost); the accepted size doubles for the next
    iteration.  No solve."""
    t = ctx.np_dtype
    g = ctx.grad(sys)
    ss = t(data["gd_step"])
    nc = 0
    with np.errstate(all="ignore"):
        while True:
            nv, x, read = ctx.combo(sys, g, variables, None, "gradient", ss)
            c, maxstep, gx, xx = (t(v) for v in read[:4])
            nc += 1
            if not c > bestcost:
                break
            ss = rules.gd_refit(ss, bestcost, gx, c)
    return nv, c, x, dict(data, gd_step=ss * t(2)), 0, nc, maxstep, xx
