"""Options, result, cost trajectory and termination bits (port of
``nllstpu/core/structs.py``)."""

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
#: A callback's termination flags are reported shifted left by this much.
TERM_USER_SHIFT = 16

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
    """Solver options (reference ``NLLSOptions``).  Every ``iterator``
    (Newton, Levenberg-Marquardt, dogleg, gradient descent) runs on every
    ``solver``: "dense" (the normal equations from autodiff or hand
    Jacobians), "cg" (the matrix-free PCG over the same blocks), "schur"
    (direct; switches to the implicit backend past the dense-W limit),
    "schur_cg" (implicit always) or "auto", which picks as the JAX package
    picks (dense for small or dense-enough systems, else Schur over
    ``schur_family`` or a detected landmark family, else "cg");
    ``max_time`` is checked every iteration.  The fields the port has come
    in the JAX package's order; the JAX package's TPU mitigations
    (``cg_fixed_iters``, ``cg_chunk_iters``, ``flat_lm``, ``fused_trial``)
    are not among them, so passing one raises ``TypeError``.

    ``store_trajectory``: ``True`` runs the stepped driver and records a
    :class:`CostTrajectory` with every iteration's cost, time and step
    vector; ``"jit"`` keeps the graph driver and records every
    iteration's cost and step norm (and, with ``jit_max_time``, its time);
    ``"jit_full"`` also every accepted step vector, copied into a
    ``[max_iters, dim]`` device buffer inside the captured trial graph.

    ``jit_max_time``: the graph driver reads the clock every iteration
    whatever this says (``max_time`` holds on either driver); set, it also
    records the iterations' times under ``store_trajectory="jit"``, as the
    JAX driver's per-iteration clock does.  ``jit_printout``: the graph
    driver prints a row per iteration in ``printout_callback``'s format."""

    rel_dcost: float = 1e-15
    abs_dcost: float = 1e-15
    dstep: float = 1e-15
    max_fails: int = 3
    max_iters: int = 100
    max_time: float = 30.0
    jit_max_time: bool = False
    jit_printout: bool = False
    iterator: str = LEVENBERG_MARQUARDT
    solver: str = "auto"
    schur_family: Any = None  # Manifold of the eliminated (landmark) family
    store_trajectory: Any = False
    # Initial iterator scalars (reference ``iteratordata`` override): 0 =
    # auto for λ and the trust radius.
    init_lm_lambda: float = 0.0
    init_trust_radius: float = 0.0
    init_gd_step: float = 1.0
    # Iterative backends (cg, schur_cg) only: relative residual tolerance
    # of the PCG (the Ceres ``eta`` analogue).  None = the backend's
    # default: 1e-5 in float32, and 1e-14 (cg) or 1e-12 (schur_cg) in
    # float64.  LM tolerates inexact steps, so 1e-2 trades inner
    # iterations for outer ones.
    linear_tol: Optional[float] = None
    # Implicit (schur_cg) only: cluster-Jacobi preconditioning (the Ceres
    # CLUSTER_JACOBI analogue) with this many consecutive cameras per
    # cluster: the exact diagonal cluster blocks of S, camera-camera
    # coupling inside a cluster included.  0 = per-camera Schur-Jacobi.
    # Applies where the JAX package applies it (one reduced family, every
    # variable of it unfixed, one components-major camera/landmark batch of
    # uniform landmark runs, at most 64 clusters); elsewhere the solve
    # keeps Schur-Jacobi (``schur.cluster_plan``).
    schur_cluster_size: int = 0

    def __post_init__(self):
        if self.iterator not in ITERATORS:
            raise ValueError(f"unknown iterator {self.iterator!r}; one of {ITERATORS}")
        if self.store_trajectory not in (False, True, "jit", "jit_full"):
            raise ValueError(f"store_trajectory={self.store_trajectory!r}: one of False, "
                             'True, "jit", "jit_full"')


@dataclasses.dataclass
class Result:
    """Optimization result (reference ``NLLSResult``).  The stepped driver
    (a callback, or ``store_trajectory=True``) measures ``time_gradient``
    (assembly), ``time_solver`` (the damped solves) and ``time_cost`` (the
    steps' application and costs), each phase ended by a device fence.
    The graph driver replays whole trials, so they are NaN there ("not
    measured"), as in the JAX package's jit driver.  ``costs`` is the
    per-iteration cost trace; ``trajectory`` the :class:`CostTrajectory`
    when one was asked for.

    The call's counters: ``replays``, the graph driver's replays per piece
    (``"assemble"``, ``"trial"``, ``"trial_lu"`` — a Cholesky that fell to
    LU —, ``"pcg_chunk"``, ...; on the CPU its eager runs; empty on the
    stepped driver); ``pcg_iterations``, the PCG iterations of each PCG
    solve (cg and implicit backends, both drivers); ``setup_seconds``, the
    host seconds of each set-up span (``"setup"``, ``"compile.layout"``,
    ``"compile.tables"``, ``"compile.build"``, ``"compile.upload"``,
    ``"graph.warmup"``, ``"graph.capture"``, ``"graph.upload"``; a cache
    hit's holds ``"setup"`` alone)."""

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
    trajectory: Optional[Any] = None  # CostTrajectory when requested
    replays: dict = dataclasses.field(default_factory=dict)
    pcg_iterations: list = dataclasses.field(default_factory=list)
    setup_seconds: dict = dataclasses.field(default_factory=dict)

    def termination_reasons(self) -> list:
        reasons = [msg for bit, msg in _TERM_MESSAGES if self.termination & bit]
        user = self.termination >> TERM_USER_SHIFT
        if user:
            reasons.append(f"Terminated by user-defined callback, with flags: {user:b}")
        return reasons

    def __str__(self):
        def t(v):
            return f"{v:f} seconds" if v == v else "unmeasured time (graph driver)"

        start, best = self.start_cost, self.best_cost
        lines = [
            f"nllstpu_torch optimization took {self.time_total:f} seconds and "
            f"{self.num_iterations} iterations to reduce the cost from "
            f"{start:e} to {best:e} "
            f"(a {100.0 * (1.0 - best / start) if start else 0.0:.2f}% reduction), using:",
            f"   {self.cost_computations} cost computations in {t(self.time_cost)},",
            f"   {self.gradient_computations} gradient computations in {t(self.time_gradient)},",
            f"   {self.linear_solves} linear solver computations in {t(self.time_solver)},",
            f"   {self.time_init:f} seconds for initialization.",
        ]
        reasons = self.termination_reasons()
        if reasons:
            lines.append("Reason(s) for termination:")
            lines.extend(f"   {r}" for r in reasons)
        return "\n".join(lines)


@dataclasses.dataclass
class CostTrajectory:
    """Per-iteration record (reference ``CostTrajectory``).  The stepped
    driver fills ``costs``, ``times_ns`` (since the driver's start) and
    ``trajectory`` (each iteration's step vector, on the host); the graph
    driver (``store_trajectory="jit"``) ``costs`` and ``step_norms``
    (|x|, from the scalars every trial reads back), ``times_ns`` with
    ``jit_max_time``, and ``trajectory`` under ``"jit_full"``."""

    costs: list = dataclasses.field(default_factory=list)
    times_ns: list = dataclasses.field(default_factory=list)
    trajectory: list = dataclasses.field(default_factory=list)
    step_norms: list = dataclasses.field(default_factory=list)
