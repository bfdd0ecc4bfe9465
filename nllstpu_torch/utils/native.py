"""ctypes binding of the native BAL parser (``native/bal_loader.cpp``; a
copy of the JAX package's ``nllstpu/utils/native.py`` that builds into the
port's own build directory, ``.torch_ext/`` at the checkout's root).

The library is built with ``g++`` at first use, or again when it is older
than its source.  Where the JAX package falls back to its numpy reader —
no source, no compiler, a failed build or load — :func:`parse_bal`
returns None and :func:`nllstpu_torch.models.bal.load_bal` reads with
numpy; ``LAST_PARSER`` says which parser the last ``load_bal`` ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "bal_loader.cpp")
_OUT = os.path.join(_ROOT, ".torch_ext")
_SO_PATH = os.path.join(_OUT, "libbal_loader.so")

#: "native" or "numpy": the parser of the last ``load_bal`` call.
LAST_PARSER = None

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    stale = (os.path.exists(_SO_PATH) and os.path.exists(_SRC)
             and os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC))
    if (not os.path.exists(_SO_PATH) or stale) and os.path.exists(_SRC):
        try:
            os.makedirs(_OUT, exist_ok=True)
            tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO_PATH)
        except Exception:
            return None
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.bal_sizes.restype = ctypes.c_int
    lib.bal_sizes.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int64)] * 3
    lib.bal_parse.restype = ctypes.c_int
    lib.bal_parse.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return _lib


def parse_bal(path: str):
    """Parse a BAL file with the native loader: the arrays dict, or None
    when the library is unavailable (the caller reads with numpy)."""
    lib = _load()
    if lib is None:
        return None
    ncam, npt, nobs = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.bal_sizes(path.encode(), ncam, npt, nobs) != 0:
        raise IOError(f"failed to read BAL header from {path}")
    c, p, k = ncam.value, npt.value, nobs.value
    cam_idx = np.empty(k, dtype=np.int32)
    pt_idx = np.empty(k, dtype=np.int32)
    obs = np.empty((k, 2), dtype=np.float64)
    cams = np.empty((c, 9), dtype=np.float64)
    pts = np.empty((p, 3), dtype=np.float64)
    rc = lib.bal_parse(path.encode(), cam_idx, pt_idx, obs, cams, pts)
    if rc != 0:
        raise IOError(f"native BAL parse failed (rc={rc}) for {path}")
    return dict(cameras=cams, points=pts, cam_idx=cam_idx, pt_idx=pt_idx, observations=obs)
