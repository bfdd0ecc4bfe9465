"""nllstpu_torch — the PyTorch and CUDA port of nllstpu.

The JAX package ``nllstpu`` is the reference; this package solves the same
problems with PyTorch, and runs its hot path through CUDA kernels written
by hand for NVIDIA Hopper (``ops/csrc``).  It covers Levenberg-Marquardt
on components-major bundle-adjustment batches through the direct Schur
solve: SE(3)+pinhole problems (``models.ba``) and Snavely BAL problems
(``models.bal``), whose skewed track lengths take the degree-bucketed
layout.  Problems live on the card unless the caller passes
``device="cpu"``.  The package never imports ``jax``.
"""

from .core.manifolds import SE3, Euclidean, Manifold, so3_exp
from .core.optimize import CompiledProblem, compile_problem, optimize, run_loop
from .core.problem import Problem, VarHandle, family_name
from .core.robust import Huber, Huber2o, NoRobust, Robustifier
from .core.structs import LEVENBERG_MARQUARDT, Options, Result

__version__ = "0.1.0"

__all__ = [
    "Manifold",
    "Euclidean",
    "SE3",
    "so3_exp",
    "Robustifier",
    "NoRobust",
    "Huber",
    "Huber2o",
    "Problem",
    "VarHandle",
    "family_name",
    "Options",
    "Result",
    "LEVENBERG_MARQUARDT",
    "compile_problem",
    "CompiledProblem",
    "optimize",
    "run_loop",
]
