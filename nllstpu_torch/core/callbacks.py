"""Built-in callbacks for the stepped driver (port of
``nllstpu/core/callbacks.py``; reference src/callbacks.jl): ``null_callback``,
``printout_callback`` and ``store_costs_callback``.  A callback is
``callback(cost, ctx) -> (cost, flags)`` with ``ctx`` a
``core.optimize.CallbackContext``; nonzero flags end the run and are
reported shifted into ``Result.termination``.  Cost trajectories are also
recorded without a callback by ``Options(store_trajectory=True)``.
"""

from __future__ import annotations

import numpy as np
import torch


def host_array(step):
    """A step vector as a numpy array on the host."""
    return step.detach().cpu().numpy() if torch.is_tensor(step) else np.asarray(step)


def null_callback(cost, ctx):
    """Do nothing (src/callbacks.jl:20)."""
    return cost, 0


def print_row(it, cost, prev_best, step, itdata):
    """One row of the per-iteration printout (the header and the start
    cost before the first): the cost, its change from the best before it,
    |step| and the iterator's trust proxy — 1/λ for LM, the trust radius
    for dogleg, the step size for gradient descent."""
    if it == 0:
        print(f"{'iter':>6} {'cost':>16} {'cost change':>16} {'|step|':>12} {'trust':>12}")
        print(f"{0:>6} {cost:>16.8e}")
        return
    lam, tr, gd = (float(itdata.get(k, 0.0)) for k in ("lm_lambda", "tr", "gd_step"))
    trust = (1.0 / lam) if lam > 0 else (tr if tr > 0 else gd)
    print(f"{it:>6} {cost:>16.8e} {prev_best - cost:>16.8e} {step:>12.4e} {trust:>12.4e}")


def printout_callback(cost, ctx):
    """Per-iteration printout (src/callbacks.jl:39-60), :func:`print_row`'s
    format; the graph driver prints the same rows under
    ``Options.jit_printout``."""
    if ctx.iteration == 1:
        print_row(0, ctx.bestcost, ctx.bestcost, 0.0, ctx.itdata)
    step = float(np.linalg.norm(host_array(ctx.step))) if ctx.step is not None else 0.0
    print_row(ctx.iteration, cost, ctx.bestcost, step, ctx.itdata)
    return cost, 0


def store_costs_callback(store):
    """Append each iteration's cost (and step, when ``store`` is a
    ``CostTrajectory``) — reference ``storecostscallback``
    (src/callbacks.jl:63-107)."""

    def cb(cost, ctx):
        if hasattr(store, "costs"):
            store.costs.append(float(cost))
            store.times_ns.append(0)
            store.trajectory.append(host_array(ctx.step))
        else:
            store.append(float(cost))
        return cost, 0

    return cb
