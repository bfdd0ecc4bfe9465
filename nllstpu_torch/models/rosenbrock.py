"""Rosenbrock test problem (port of ``nllstpu/models/rosenbrock.py``,
reference examples/rosenbrock.jl and test/functional.jl:5-25): residuals
a·(1−x) (robustified Scaled∘Huber2o) and b·(x²−y), as single costs."""

from __future__ import annotations

from ..core.manifolds import Scalar
from ..core.problem import Problem
from ..core.robust import Huber2o, Scaled


def residual_a(a, x):
    return a * (1.0 - x)


def residual_b(b, x, y):
    return b * (x * x - y)


def make_rosenbrock(a=1.0, b=10.0, x0=0.0, y0=0.0, robust=True, dtype=None, device=None):
    """Build the 2-variable Rosenbrock problem; returns ``(problem,
    x_handle, y_handle)``."""
    p = Problem(dtype=dtype, device=device)
    x = p.add_variable(Scalar(), x0)
    y = p.add_variable(Scalar(), y0)
    kernel = Scaled(Huber2o(1.6), 1.0) if robust else None
    p.add_cost(residual_a, (x,), params=a, kernel=kernel)
    p.add_cost(residual_b, (x, y), params=b)
    return p, x, y
