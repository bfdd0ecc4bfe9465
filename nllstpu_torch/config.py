"""Global configuration for the PyTorch port.

Unlike the JAX package, nothing global is switched on at import: PyTorch
keeps float64 available everywhere, and every :class:`Problem` names its own
``dtype`` and ``device``.  The device defaults to the card: a caller who
wants the CPU (the tests) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

#: Default scalar dtype for solver state (the reference computes in Float64).
default_dtype = torch.float64

#: Maximum number of variable blocks one cost may depend on (reference
#: ``MAX_ARGS = 10``), kept as an API sanity check.
MAX_ARGS = 10


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """Host storage dtype matching a torch floating dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); anything else is passed to
    ``torch.device``.  A CUDA device on a host without one raises: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but no CUDA device "
            "is available; pass device=\"cpu\" to run on the CPU"
        )
    return dev
