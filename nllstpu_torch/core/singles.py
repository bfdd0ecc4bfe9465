"""Per-variable alternation: optimize many single variables at once (port
of ``nllstpu/core/singles.py``, reference ``optimizesingles!``).

The JAX package ``vmap``s its ``run_loop`` over the targets: one LM (or
Newton, dogleg, gradient descent) per variable, each lane stepping until
the last one ends, finished lanes frozen.  Here the same thing is ONE
batched loop over every target of a family: the iterator's state is a
tensor per quantity (λ, trust radius, gradient step, best cost, fails,
termination bits, ...), a trial solves every lane's d×d system in one
batched Cholesky (LU where a lane's factorization fails,
``linearsolver.batched_cholesky_solve``), accept and termination are
per-lane masks, and the host reads one flag per trial round (whether any
lane still tries) — no per-variable Python.  The per-step rules (λ,
trust radius, line search, acceptance, termination bits) are
``core/rules.py``'s, the same the drivers' host loop calls; only the
masking lives here.

Each (batch, slot) pair whose slot lies in the family contributes the
costs whose slot variable is a target, sorted by target at set-up (the
JAX package's ``_pair_row_lists``); the other slots' values are gathered
once.  Cost, gradient and Hessian of each cost in the slot's tangent
(``engine.rows_grad_hess_slot``) are summed per target by kernel B6
(``segment_block_sum``, D = 1 + d + d², one launch per pair), and every
trial's cost the same way (D = 1).

Semantics: Jacobi, as in the JAX package — every solve sees the initial
values of the other variables (the reference's serial sweep is
Gauss-Seidel).  Where no cost couples two targets (landmark polish, the
case this API exists for) the two agree.  ``Options.max_time`` and
``jit_printout`` are ignored, as the JAX package's vmapped loop ignores
them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import engine, rules, structs
from .linearsolver import batched_cholesky_solve
from .manifolds import Manifold
from .problem import Problem, family_name
from .structs import Options


def _pair_rows(batch, slot, targets):
    """``(rows, lanes, starts)``: the real costs of ``batch`` whose ``slot``
    variable is a target, grouped by target in target order (each
    target's costs in batch order; a repeated target gets its costs
    again), the lane of each, and each lane's run ``[T+1]``."""
    idx = np.asarray(batch.idx[slot])
    valid = np.nonzero(np.asarray(batch.mask))[0]
    order = valid[np.argsort(idx[valid], kind="stable")]
    sorted_ids = idx[order]
    first = np.searchsorted(sorted_ids, targets, side="left")
    counts = np.searchsorted(sorted_ids, targets, side="right") - first
    starts = np.concatenate([[0], np.cumsum(counts)])
    lanes = np.repeat(np.arange(len(targets)), counts)
    within = np.arange(starts[-1]) - starts[:-1][lanes]
    rows = order[first[lanes] + within] if starts[-1] else np.zeros(0, np.int64)
    return rows, lanes, starts


class _Pair:
    """One (batch, slot) pair on the device: its costs' parameters, the
    other slots' values (fixed for the whole solve), each cost's lane and
    the lanes' runs."""

    def __init__(self, batch, slot, targets, fam_arrays, dtype, device):
        rows, lanes, starts = _pair_rows(batch, slot, targets)
        self.batch, self.slot = batch, slot
        self.n = rows.shape[0]
        self.lanes = torch.as_tensor(lanes, dtype=torch.long, device=device)
        self.starts = torch.as_tensor(starts, dtype=torch.int32, device=device)
        self.params = (None if batch.params is None else
                       torch.as_tensor(np.asarray(batch.params)[rows], dtype=dtype,
                                       device=device))
        self.vals = [
            fam_arrays[family_name(m)][torch.as_tensor(np.asarray(i)[rows], dtype=torch.long,
                                                       device=device)]
            for m, i in zip(batch.manifolds, batch.idx)
        ]

    def values(self, lane_values):
        v = list(self.vals)
        v[self.slot] = lane_values[self.lanes]
        return tuple(v)


class _Lanes:
    """The per-target sums of one family's pairs: cost, g and H at the
    lanes' values, and the cost alone, each summed per lane by B6."""

    def __init__(self, pairs, d, segment_sum):
        self.pairs, self.d, self.segment_sum = pairs, d, segment_sum

    def assemble(self, values):
        """``(cost [T], g [T, d], H [T, d, d])``."""
        d, total = self.d, None
        for p in self.pairs:
            if p.n == 0:
                continue
            c, g, h = engine.rows_grad_hess_slot(p.batch, p.params, p.values(values), p.slot)
            rows = torch.cat([c[:, None], g, h.reshape(-1, d * d)], dim=1)
            s = self.segment_sum(rows, p.starts)
            total = s if total is None else total + s
        if total is None:
            total = values.new_zeros(values.shape[0], 1 + d + d * d)
        return total[:, 0], total[:, 1 : 1 + d], total[:, 1 + d :].reshape(-1, d, d)

    def cost(self, values):
        """``cost [T]``."""
        total = None
        for p in self.pairs:
            if p.n == 0:
                continue
            c = engine.rows_cost(p.batch, p.params, p.values(values))
            s = self.segment_sum(c[:, None], p.starts)[:, 0]
            total = s if total is None else total + s
        return values.new_zeros(values.shape[0]) if total is None else total


def optimize_singles(problem: Problem, options: Options = None, targets=None) -> dict:
    """Optimize each target variable on its own, every other variable
    fixed (reference ``optimizesingles!``).  ``targets`` is a
    :class:`Manifold` (every variable of that family) or an iterable of
    handles.  The variables are updated in place; returns, per family, the
    iterations summed over its targets."""
    from . import optimize as _opt

    options = options or Options()
    if targets is None:
        raise ValueError("optimize_singles requires targets (a Manifold or handles)")
    if isinstance(targets, Manifold):
        fam_targets = {family_name(targets): None}
    else:
        fam_targets = {}
        for h in targets:
            fam_targets.setdefault(h.family, []).append(h.index)
    batches = problem.batches()
    fam_arrays = problem.stacked_variables()
    segment_sum = _opt.KERNELS.segment_sum
    summary = {}
    for fam, indices in fam_targets.items():
        man = problem.manifold_of(fam)
        n_all = fam_arrays[fam].shape[0]
        tgt = np.arange(n_all) if indices is None else np.asarray(sorted(indices), np.int64)
        pairs = [
            _Pair(b, s, tgt, fam_arrays, problem.dtype, problem.device)
            for b in batches for s, m in enumerate(b.manifolds) if family_name(m) == fam
        ]
        if not pairs:
            raise ValueError(f"no costs touch family {fam}")
        lanes = _Lanes(pairs, man.dof, segment_sum)
        tgt_t = torch.as_tensor(tgt, dtype=torch.long, device=problem.device)
        new_values, iters = run_lanes(lanes, man, fam_arrays[fam][tgt_t], options)
        arr = fam_arrays[fam].clone()
        arr[tgt_t] = new_values
        fam_arrays = dict(fam_arrays, **{fam: arr})
        summary[fam] = int(iters.sum())
    problem.set_values(fam_arrays)
    return summary


def _any(mask) -> bool:
    """The loop's one host read per round."""
    return bool(mask.any())


def _bcast(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _sel(mask, a, b):
    """``a`` where ``mask`` (per lane), else ``b``."""
    return torch.where(_bcast(mask, a), a, b)


class _Trial:
    """A lane-wise trial at steps ``x [T, d]``: the variables, their cost
    and the scalars the iterators read."""

    def __init__(self, lanes, man, values, x):
        self.x = x
        self.values = man.retract(values, x)
        self.cost = lanes.cost(self.values)
        self.maxstep = x.abs().amax(-1)
        self.xx = (x * x).sum(-1)


def _keep(mask, new: _Trial, old: _Trial):
    """Per lane, ``new``'s fields where ``mask``, else ``old``'s."""
    if old is None:
        return new
    for k in ("x", "values", "cost", "maxstep", "xx"):
        setattr(old, k, _sel(mask, getattr(new, k), getattr(old, k)))
    return old


def _levmar(lanes, man, values, g, h, best, st, live, opts):
    """Lane-wise Levenberg-Marquardt (``iterators._levmar``): λ from
    1e-6·max|diag H| when 0, ×µ (µ doubling) per rejected trial, the
    quality rule on the accepted one."""
    lam = rules.lm_start(st["lam"], torch.diagonal(h, dim1=-2, dim2=-1).abs().amax(-1))
    mu = torch.full_like(lam, 2.0)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    pending, trial = live.clone(), None
    while _any(pending):
        x = -batched_cholesky_solve(h + lam[:, None, None] * eye, g)
        t = _Trial(lanes, man, values, x)
        trial = _keep(pending, t, trial)
        grow = pending & ~rules.accepts(t.cost, best, t.maxstep, opts.dstep)
        lam_up, mu_up = rules.lm_reject(lam, mu)
        lam, mu = torch.where(grow, lam_up, lam), torch.where(grow, mu_up, mu)
        pending = grow
    gx = (g * trial.x).sum(-1)
    st["lam"] = torch.where(live, rules.lm_accept(lam, trial.cost, best, gx, trial.xx), st["lam"])
    return trial


def _newton(lanes, man, values, g, h, best, st, live, opts):
    """Lane-wise Newton: the undamped solve, one trial."""
    return _Trial(lanes, man, values, -batched_cholesky_solve(h, g))


def _dogleg(lanes, man, values, g, h, best, st, live, opts):
    """Lane-wise dogleg (``iterators._dogleg``): the Cauchy point, the
    Newton leg or their blend on the trust circle, the ×3 / ×0.5 radius
    rule, a halved radius after a non-finite trial."""
    tiny = torch.finfo(g.dtype).tiny
    xn = -batched_cholesky_solve(h, g)
    ghg = torch.einsum("ti,tij,tj->t", g, h, g)
    gnorm2 = (g * g).sum(-1)
    coef, alpha2, alpha = rules.dogleg_leg(gnorm2, ghg, tiny)
    cauchy = -coef[:, None] * g
    dleg = xn - cauchy
    sq_leg = (dleg * dleg).sum(-1)
    cdot = (cauchy * dleg).sum(-1)
    tr = torch.where(st["tr"] == 0, alpha, st["tr"])
    beta = torch.sqrt((xn * xn).sum(-1))
    c_prev = best.clone()
    pending, trial = live.clone(), None
    while _any(pending):
        first, full, s, lin = rules.dogleg_point(tr, coef, alpha2, alpha, beta, gnorm2, cdot,
                                                 sq_leg, c_prev, tiny)
        x = _sel(first, s[:, None] * cauchy, _sel(full, xn, dleg * s[:, None] + cauchy))
        t = _Trial(lanes, man, values, x)
        trial = _keep(pending, t, trial)
        tr = torch.where(pending, rules.dogleg_radius(tr, best, t.cost, lin, t.xx), tr)
        done = rules.accepts(t.cost, best, t.maxstep, opts.dstep)
        c_prev = torch.where(pending, t.cost, c_prev)
        pending = pending & ~done
    st["tr"] = torch.where(live, tr, st["tr"])
    return trial


def _gradient_descent(lanes, man, values, g, h, best, st, live, opts):
    """Lane-wise gradient descent with the reference's quadratic-fit line
    search (``iterators._gradient_descent``)."""
    ss = st["gd"]
    trial = _Trial(lanes, man, values, -g * ss[:, None])
    pending = live & (trial.cost > best)
    while _any(pending):
        gx = (trial.x * g).sum(-1)
        ss = torch.where(pending, rules.gd_refit(ss, best, gx, trial.cost), ss)
        t = _Trial(lanes, man, values, -g * ss[:, None])
        trial = _keep(pending, t, trial)
        pending = pending & (t.cost > best)
    st["gd"] = torch.where(live, ss * 2, st["gd"])
    return trial


_ITERATORS = {
    structs.LEVENBERG_MARQUARDT: _levmar,
    structs.NEWTON: _newton,
    structs.DOGLEG: _dogleg,
    structs.GRADIENT_DESCENT: _gradient_descent,
}


def run_lanes(lanes, man, values0, opts: Options):
    """:func:`core.optimize.run_loop`'s control flow (the reference's
    ``optimizeinternal!``) for every lane at once: the iterator's step,
    unconditional adoption, the best-value snapshot on the first
    consecutive failure, the termination bits, and the rollback at the
    end; a lane whose bits are set is frozen.  Returns ``(values [T,
    ...], iterations [T])``."""
    step = _ITERATORS[opts.iterator]
    dt = values0.dtype
    n_lanes = values0.shape[0]
    i32 = dict(dtype=torch.int32, device=values0.device)
    values = values0.clone()
    best = lanes.cost(values)
    st = dict(
        lam=torch.full((n_lanes,), opts.init_lm_lambda, dtype=dt, device=values.device),
        tr=torch.full((n_lanes,), opts.init_trust_radius, dtype=dt, device=values.device),
        gd=torch.full((n_lanes,), opts.init_gd_step, dtype=dt, device=values.device),
        fails=torch.zeros(n_lanes, **i32),
    )
    varbest, last = values.clone(), best.clone()
    iternum = torch.zeros(n_lanes, **i32)
    bits = torch.zeros(n_lanes, **i32)
    live = torch.ones(n_lanes, dtype=torch.bool, device=values.device)
    while _any(live):
        _, g, h = lanes.assemble(values)
        trial = step(lanes, man, values, g, h, best, st, live, opts)
        c = trial.cost
        accepted, fails, new_best, b = rules.outer_update(c, best, trial.maxstep, st["fails"],
                                                          iternum + 1, opts)
        snap = live & ~accepted & (st["fails"] == 0)
        varbest = _sel(snap, values, varbest)
        st["fails"] = torch.where(live, fails, st["fails"])
        best = torch.where(live, new_best, best)
        last = torch.where(live, c, last)
        values = _sel(live, trial.values, values)
        iternum = torch.where(live, iternum + 1, iternum)
        bits = torch.where(live, b, bits)
        live = bits == 0
    values = _sel(~(best >= last), varbest, values)
    return values, iternum
