"""nllstpu_torch — the PyTorch and CUDA port of nllstpu.

The JAX package ``nllstpu`` is the reference; this package solves the same
problems with PyTorch, and runs its hot path through CUDA kernels written
by hand for NVIDIA Hopper (``ops/csrc``).  Every iterator (Newton,
Levenberg-Marquardt, dogleg, gradient descent) runs on four backends: the
dense normal equations of any cost batch (single costs, per-cost,
row-major or components-major batches; autodiff or hand Jacobians; the
small models ``rosenbrock``, ``curvefit``, ``posegraph``, affine BA), the
matrix-free PCG over the same per-cost blocks (``solver="cg"``, what
``solver="auto"`` takes for a pose graph), and the Schur solves, direct
and implicit (``solver="schur_cg"``, and ``solver="schur"`` past the
dense-W limit): every batch form, priors, pose-graph edges, several
reduced families, fixed cameras and fixed landmarks; SE(3)+pinhole
problems (``models.ba``) and Snavely BAL problems (``models.bal``),
whose components-major batches take the obs-major route and, with skewed
track lengths, the degree-bucketed layout in the direct solve.  ``solver="auto"`` picks as the JAX package
picks, and the entry points take its signatures.  A BAL
batch may carry one shared adaptive robust kernel (ContaminatedGaussian,
Barron) whose parameters are fitted with the cameras and points, through
the direct solve.  Problems live on the card unless the caller passes
``device="cpu"``.  ``optimize`` runs the graph driver (CUDA graphs of the
assembly, the damped trial and the PCG's chunks) unless the caller passes
a ``callback`` or ``store_trajectory=True``, which take the stepped
driver; a second ``optimize`` of a problem whose structure is unchanged
reuses the compiled problem and its graphs.  ``optimize_singles`` solves
every variable of a family on its own in one batched loop (landmark
polish), ``SubproblemView`` swaps cost subsets without compiling again,
and ``ops.export``, ``utils.checkpoint``, ``utils.profiling`` and
``utils.native`` (the C++ BAL parser) are the JAX package's utilities.
``nllstpu_torch.parallel`` runs the Schur solves landmark-sharded across
the ranks of a ``torch.distributed`` group (``optimize_sharded``), and
sums the dense or direct system over them (``parallelize``).
The package never imports ``jax``.
"""

from .core.manifolds import (
    SE3, SO3, BarronManifold, ContaminatedGaussianManifold, Euclidean, Manifold,
    Scalar, ZeroToInf, ZeroToOne, so3_exp, so3_log,
)
from .core.callbacks import null_callback, printout_callback, store_costs_callback
from .core.optimize import (
    CallbackContext, CompiledProblem, SubproblemView, compile_problem, cost, optimize,
    run_graphs, run_loop, run_stepped,
)
from .core.singles import optimize_singles
from .core.problem import Problem, VarHandle, family_name
from .core.robust import (
    AdaptiveRobustifier, Barron, Cauchy, ContaminatedGaussian, GemanMcclure, Huber,
    Huber2o, NoRobust, Robustifier, Scaled, ScaledAdaptive, Tukey, Welsch, em_fit,
)
from .core.structs import (
    DOGLEG, GRADIENT_DESCENT, LEVENBERG_MARQUARDT, NEWTON, CostTrajectory, Options, Result,
)

__version__ = "0.1.0"

__all__ = [
    "Manifold",
    "Euclidean",
    "SO3",
    "SE3",
    "so3_exp",
    "so3_log",
    "Scalar",
    "ZeroToInf",
    "ZeroToOne",
    "ContaminatedGaussianManifold",
    "BarronManifold",
    "Robustifier",
    "NoRobust",
    "Huber",
    "Huber2o",
    "Scaled",
    "GemanMcclure",
    "Cauchy",
    "Welsch",
    "Tukey",
    "AdaptiveRobustifier",
    "ScaledAdaptive",
    "ContaminatedGaussian",
    "Barron",
    "em_fit",
    "Problem",
    "VarHandle",
    "family_name",
    "Options",
    "Result",
    "CostTrajectory",
    "NEWTON",
    "LEVENBERG_MARQUARDT",
    "DOGLEG",
    "GRADIENT_DESCENT",
    "compile_problem",
    "cost",
    "CompiledProblem",
    "optimize",
    "SubproblemView",
    "optimize_singles",
    "run_loop",
    "run_stepped",
    "run_graphs",
    "CallbackContext",
    "null_callback",
    "printout_callback",
    "store_costs_callback",
]
