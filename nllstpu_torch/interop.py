"""Carry a problem across from plain arrays.

``problem_from_arrays`` builds a port :class:`Problem` from the stacked
variables and the padded cost-batch arrays of the JAX package's problem,
handed over as numpy, so that both packages solve bit-identical inputs.
Nothing here imports jax.
"""

from __future__ import annotations

import re

import numpy as np

from .core import manifolds
from .core.manifolds import Euclidean, Manifold
from .core.problem import Problem

#: Ported manifolds whose family key is their class name and ``()``.
_NO_ARGS = {
    f"{cls.__name__}()": cls
    for cls in (
        manifolds.SE3, manifolds.SO3, manifolds.Scalar, manifolds.ZeroToInf, manifolds.ZeroToOne,
        manifolds.ContaminatedGaussianManifold, manifolds.BarronManifold,
    )
}


def manifold_from_name(name: str) -> Manifold:
    """The port manifold of a family key (``"SE3()"``, ``"Euclidean(n=3)"``,
    ``"ContaminatedGaussianManifold()"``, ...)."""
    if name in _NO_ARGS:
        return _NO_ARGS[name]()
    m = re.fullmatch(r"Euclidean\(n=(\d+)\)", name)
    if m:
        return Euclidean(int(m.group(1)))
    raise NotImplementedError(f"manifold {name!r} is not ported yet")


def problem_from_arrays(variables: dict, batches: list, dtype, device=None) -> Problem:
    """``variables`` maps family keys to stacked ``[n, *shape]`` arrays;
    each entry of ``batches`` is a dict with ``fn`` and ``jacobian`` (the
    port's residual and hand Jacobian), ``manifolds`` (port manifolds per
    slot), ``idx`` (per-slot index arrays), ``params``, ``mask`` (padded
    as the JAX package pads) and optionally ``kernel``, a port kernel: an
    adaptive one with its parameter variable's family in ``variables`` and
    its slot first.  The real (masked) costs are added in order, so the
    port pads them back identically.  ``batched`` (default ``"cm"``) and
    ``kind`` give the batch's form, as ``Problem.add_cost_batch`` takes
    them; ``jacobian`` may be None (autodiff)."""
    p = Problem(dtype=dtype, device=device)
    for name, values in variables.items():
        p.add_variables(manifold_from_name(name), np.asarray(values))
    for b in batches:
        mask = np.asarray(b["mask"], dtype=bool)
        params = b.get("params")
        p.add_cost_batch(
            b["fn"],
            slots=[
                (m, np.asarray(i)[mask]) for m, i in zip(b["manifolds"], b["idx"])
            ],
            params=None if params is None else np.asarray(params)[mask],
            kernel=b.get("kernel"),
            jacobian=b.get("jacobian"),
            batched=b.get("batched", "cm"),
            kind=b.get("kind", "residual"),
        )
    return p
