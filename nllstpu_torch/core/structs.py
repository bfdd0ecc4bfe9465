"""Options, result and termination bits (port of
``nllstpu/core/structs.py`` for the slice: Levenberg-Marquardt on the
direct Schur backend)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

NEWTON = "newton"
LEVENBERG_MARQUARDT = "levenberg_marquardt"
DOGLEG = "dogleg"
GRADIENT_DESCENT = "gradient_descent"

ITERATORS = (NEWTON, LEVENBERG_MARQUARDT, DOGLEG, GRADIENT_DESCENT)

# Termination bits (reference src/optimize.jl:151-161).
TERM_COST_INF = 1 << 0
TERM_COST_NAN = 1 << 1
TERM_RELDCOST = 1 << 2
TERM_ABSDCOST = 1 << 3
TERM_STEP_INF = 1 << 4
TERM_STEP_NAN = 1 << 5
TERM_SMALL_STEP = 1 << 6
TERM_MAX_FAILS = 1 << 7
TERM_MAX_ITERS = 1 << 8
TERM_MAX_TIME = 1 << 9

_TERM_MESSAGES = (
    (TERM_COST_INF, "Cost is infinite."),
    (TERM_COST_NAN, "Cost is NaN."),
    (TERM_RELDCOST, "Relative decrease in cost below threshold."),
    (TERM_ABSDCOST, "Absolute decrease in cost below threshold."),
    (TERM_STEP_INF, "Step contains an infinite value."),
    (TERM_STEP_NAN, "Step contains a NaN."),
    (TERM_SMALL_STEP, "Step size below threshold."),
    (TERM_MAX_FAILS, "Too many consecutive iterations increasing the cost."),
    (TERM_MAX_ITERS, "Maximum number of outer iterations reached."),
    (TERM_MAX_TIME, "Maximum allowed computation time exceeded."),
)


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver options (reference ``NLLSOptions``).  The port runs
    ``iterator=LEVENBERG_MARQUARDT`` with ``solver="schur"`` (or "auto"
    with a ``schur_family``), which switches to the implicit backend past
    the dense-W limit, or ``solver="schur_cg"`` (implicit always);
    ``max_time`` is checked every iteration."""

    rel_dcost: float = 1e-15
    abs_dcost: float = 1e-15
    dstep: float = 1e-15
    max_fails: int = 3
    max_iters: int = 100
    max_time: float = 30.0
    iterator: str = LEVENBERG_MARQUARDT
    solver: str = "auto"
    schur_family: Any = None  # Manifold of the eliminated (landmark) family
    init_lm_lambda: float = 0.0
    # Implicit backend only: relative residual tolerance of the reduced
    # PCG (the Ceres ``eta`` analogue).  None = 1e-5 in float32, 1e-12 in
    # float64.  LM tolerates inexact steps, so 1e-2 trades inner
    # iterations for outer ones.
    linear_tol: Optional[float] = None

    def __post_init__(self):
        if self.iterator not in ITERATORS:
            raise ValueError(f"unknown iterator {self.iterator!r}; one of {ITERATORS}")


@dataclasses.dataclass
class Result:
    """Optimization result (reference ``NLLSResult``).  ``time_cost``,
    ``time_gradient`` and ``time_solver`` are NaN ("not measured"): the
    device runs ahead of the host, so host clocks around phases would time
    the enqueue; per-phase device times come from CUDA events (see
    ``IterCtx.phase``).  ``costs`` is the per-iteration cost trace."""

    start_cost: float
    best_cost: float
    time_total: float
    time_init: float
    time_cost: float
    time_gradient: float
    time_solver: float
    termination: int
    num_iterations: int
    cost_computations: int
    gradient_computations: int
    linear_solves: int
    costs: Optional[list] = None

    def termination_reasons(self) -> list:
        return [msg for bit, msg in _TERM_MESSAGES if self.termination & bit]

    def __str__(self):
        start, best = self.start_cost, self.best_cost
        lines = [
            f"nllstpu_torch optimization took {self.time_total:f} seconds and "
            f"{self.num_iterations} iterations to reduce the cost from "
            f"{start:e} to {best:e} "
            f"(a {100.0 * (1.0 - best / start) if start else 0.0:.2f}% reduction), using:",
            f"   {self.cost_computations} cost computations,",
            f"   {self.gradient_computations} gradient computations,",
            f"   {self.linear_solves} linear solver computations,",
            f"   {self.time_init:f} seconds for initialization.",
        ]
        reasons = self.termination_reasons()
        if reasons:
            lines.append("Reason(s) for termination:")
            lines.extend(f"   {r}" for r in reasons)
        return "\n".join(lines)
