"""The iterators' per-step rules, written once for both loops that use
them: the drivers' outer loop and iterators (``core/optimize.py:
run_loop``, ``core/iterators.py``), which hold each quantity as a host
numpy scalar of the problem's dtype, and ``optimize_singles``' batched
loop (``core/singles.py``), which holds one per target as a ``[T]``
tensor.  Each rule takes either kind and returns the same kind, with the
same expressions in the same order, so the two loops round alike; the
loops keep only their control flow (the host's branches, the lanes'
masks).

On host scalars the constants are cast to the operands' numpy type and a
selection is a plain conditional; on tensors the constants stay Python
numbers (weak, so the tensors' dtype holds) and a selection is
``torch.where``.  Every branch is evaluated, so a host caller runs these
under ``np.errstate(all="ignore")``.
"""

from __future__ import annotations

import numpy as np
import torch


class _Host:
    """Numpy scalars of one dtype."""

    @staticmethod
    def where(cond, a, b):
        return a if cond else b

    @staticmethod
    def const(like, v):
        return type(like)(v)

    @staticmethod
    def bit(cond, k):
        return int(cond) << k

    @staticmethod
    def not_(cond):
        return not cond

    sqrt = staticmethod(np.sqrt)
    isfinite = staticmethod(np.isfinite)
    isinf = staticmethod(np.isinf)
    isnan = staticmethod(np.isnan)
    maximum = staticmethod(np.maximum)


class _Lanes:
    """Per-lane tensors."""

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def const(like, v):
        return v

    @staticmethod
    def bit(cond, k):
        return cond.to(torch.int32) << k

    @staticmethod
    def not_(cond):
        return ~cond

    @staticmethod
    def maximum(a, b):
        return torch.maximum(a, b) if torch.is_tensor(b) else torch.clamp(a, min=b)

    sqrt = staticmethod(torch.sqrt)
    isfinite = staticmethod(torch.isfinite)
    isinf = staticmethod(torch.isinf)
    isnan = staticmethod(torch.isnan)


def _ns(x):
    return _Lanes if torch.is_tensor(x) else _Host


def termination_bits(cost, dcost, bestcost, maxstep, fails, iternum, opts):
    """The reference's termination bitmask (src/optimize.jl:149-165)."""
    m = _ns(cost)
    return (m.bit(m.isinf(cost), 0) | m.bit(m.isnan(cost), 1)
            | m.bit(dcost < bestcost * opts.rel_dcost, 2) | m.bit(dcost < opts.abs_dcost, 3)
            | m.bit(m.isinf(maxstep), 4) | m.bit(m.isnan(maxstep), 5)
            | m.bit(maxstep < opts.dstep, 6) | m.bit(fails > opts.max_fails, 7)
            | m.bit(iternum >= opts.max_iters, 8))


def outer_update(cost, bestcost, maxstep, fails, iternum, opts):
    """One outer iteration's bookkeeping (reference
    ``optimizeinternal!``): a trial no worse than the best is accepted,
    which resets the failure count and makes its cost the best; the
    termination bits read the decrease (the cost itself when rejected).
    ``iternum`` is the iteration just taken.  Returns ``(accepted, fails,
    bestcost, bits)``."""
    m = _ns(cost)
    dcost = bestcost - cost
    accepted = dcost >= 0
    fails = m.where(accepted, 0, fails + 1)
    bestcost = m.where(accepted, cost, bestcost)
    bits = termination_bits(cost, m.where(accepted, dcost, cost), bestcost, maxstep,
                            fails, iternum, opts)
    return accepted, fails, bestcost, bits


def accepts(cost, bestcost, maxstep, dstep):
    """The retry loops' exit: a finite cost no higher than the best, a
    step below ``dstep``, or a NaN step (λ cannot rescue a NaN system)."""
    m = _ns(cost)
    return ((m.not_(cost > bestcost) & m.isfinite(cost)) | (maxstep < dstep)
            | m.isnan(maxstep))


def lm_start(lam, diag_max):
    """Levenberg-Marquardt's λ: 1e-6·max|diag H| where it is 0 (auto)."""
    m = _ns(lam)
    return m.where(lam == 0, diag_max * m.const(lam, 1e-6), lam)


def lm_reject(lam, mu):
    """A rejected trial: λ times µ, µ doubled."""
    return lam * mu, mu * _ns(mu).const(mu, 2)


def lm_accept(lam, cost, bestcost, gx, xx):
    """λ after the accepted trial: scaled by ``ρ < 0.983 ? 1 − (2ρ−1)³ :
    0.1``, with ρ the step quality against the undamped quadratic model,
    0.5·(gᵀx − λ|x|²) for the damped solve."""
    m = _ns(lam)
    k = lambda v: m.const(lam, v)  # noqa: E731
    quality = (cost - bestcost) / (k(0.5) * (gx - lam * xx))
    factor = m.where(quality < 0.983, k(1) - (k(2) * quality - k(1)) ** 3, k(0.1))
    return lam * factor


def dogleg_leg(gnorm2, ghg, tiny):
    """The Cauchy leg's scalars from gᵀg and gᵀHg: ``(coef, α², α)``,
    the Cauchy point being −coef·g and α its length."""
    coef = gnorm2 / (ghg + tiny)
    alpha2 = coef * coef * gnorm2
    return coef, alpha2, _ns(gnorm2).sqrt(alpha2)


def dogleg_point(tr, coef, alpha2, alpha, beta, gnorm2, cdot, sq_leg, c_prev, tiny):
    """The dogleg step for trust radius ``tr`` (the JAX package's jit
    form): the Cauchy point scaled to the radius where it reaches it
    (``first``), else the Newton leg where it fits (``full``), else the
    Cauchy→Newton segment's crossing of the circle.  β = |x_n|, ``cdot`` =
    cᵀ(x_n − c), ``sq_leg`` = |x_n − c|².  Returns ``(first, full, s,
    lin)``: the step is s·c, x_n, or (x_n − c)·s + c, and ``lin`` the
    model decrease its quality is measured against."""
    m = _ns(tr)
    k = lambda v: m.const(tr, v)  # noqa: E731
    first = m.not_(alpha < tr)
    full = beta <= tr
    trsq = tr * tr - alpha2
    root = m.sqrt(m.maximum(cdot * cdot + sq_leg * trsq, k(0)))
    s3 = m.where(cdot <= 0, (-cdot + root) / (sq_leg + tiny), trsq / (cdot + root + tiny))
    lin1 = tr * (k(2) * alpha - tr) / (k(2) * coef)
    lin3 = k(0.5) * (coef * (k(1) - s3) ** 2 * gnorm2) + s3 * (k(2) - s3) * c_prev
    s = m.where(first, tr / alpha, m.where(full, k(0), s3))
    lin = m.where(first, lin1, m.where(full, c_prev, lin3))
    return first, full, s, lin


def dogleg_radius(tr, bestcost, cost, lin, xx):
    """The trust radius after a trial: ×3 (at least) at quality above
    0.375, ×0.5 below 0.125, and ×0.5 after a non-finite cost."""
    m = _ns(tr)
    k = lambda v: m.const(tr, v)  # noqa: E731
    mu = (bestcost - cost) / lin
    tr_new = m.where(mu > 0.375, m.maximum(tr, k(3) * m.sqrt(xx)),
                     m.where(mu < 0.125, tr * k(0.5), tr))
    return m.where(m.isfinite(cost), tr_new, tr * k(0.5))


def gd_refit(ss, bestcost, gx, cost):
    """Gradient descent's line search: a rejected step of size s refitted
    to s·½·gᵀx / (best + gᵀx − cost)."""
    return ss * _ns(ss).const(ss, 0.5) * gx / (bestcost + gx - cost)
