"""Checkpoint and resume of the variable state (port of
``nllstpu/utils/checkpoint.py``): every variable family of a problem, and
optional extra scalars, in a plain ``.npz`` — the same keys
(``var::<family>``, ``extra::<name>``) and the same family names, so a
file saved by either package loads in the other.
"""

from __future__ import annotations

import numpy as np


def save_variables(path: str, problem, extra: dict = None):
    """Save every variable family of ``problem`` (plus ``extra`` scalars,
    e.g. the current LM λ) to ``path``."""
    payload = {f"var::{name}": np.asarray(fam.values) for name, fam in problem._families.items()}
    for key, val in (extra or {}).items():
        payload[f"extra::{key}"] = np.asarray(val)
    np.savez(path, **payload)


def load_variables(path: str, problem) -> dict:
    """Restore the values saved by :func:`save_variables` into ``problem``
    (families must match by name and shape); returns the extras."""
    data = np.load(path)
    extras = {}
    for key in data.files:
        if key.startswith("var::"):
            name = key[len("var::"):]
            fam = problem._families.get(name)
            if fam is None:
                raise KeyError(f"problem has no variable family {name!r}")
            arr = data[key]
            if arr.shape != fam.values.shape:
                raise ValueError(f"family {name!r}: saved shape {arr.shape} != current "
                                 f"{fam.values.shape}")
            fam.values[:] = arr
        elif key.startswith("extra::"):
            extras[key[len("extra::"):]] = data[key]
    return extras
