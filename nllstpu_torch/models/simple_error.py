"""Generic measurement-error residuals (port of
``nllstpu/models/simple_error.py``; reference ``SimpleError2/3/4``,
src/residual.jl:3-41): ``generate(values...) − measurement``, the
measurement passed as the cost's ``params``."""

from __future__ import annotations


def measurement_residual(generate_fn):
    """Wrap ``generate_fn(*values) -> prediction`` into a residual
    ``prediction − measurement`` for ``add_cost`` / ``add_cost_batch``
    (measurement passed as ``params``)."""

    def residual(measurement, *values):
        return generate_fn(*values) - measurement

    residual.__name__ = f"measurement_residual_{getattr(generate_fn, '__name__', 'fn')}"
    return residual
