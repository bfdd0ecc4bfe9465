"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch header is included, so a cold build
takes seconds rather than minutes, and no ``ninja`` is needed.  The library lands in
``.torch_ext/`` at the repository root under a name that hashes the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The build runs at first use, never at import; a failed build
raises.

Each exported launcher enqueues on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch (0 = success).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_OUT = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: argtypes of every exported launcher (the suffix names the float type,
#: then, for B6, the index type of ``starts``).
_SIGNATURES = {
    # B1 and B8 (cpos and rows NULL): jac, g0, d1, d2, vc, cpos, h_ll, g_l,
    # w, rows, n, s, k, l, n_r, n_rows, dr_s, dl, e_start, then the element
    # strides jsn, jss, gss, sk, sl, gk, gl, stream
    **{
        f"{base}_{f}": [_P] * 10 + [_I] * 9 + [_LL] * 7 + [_P]
        for base in ("fused_obs_all", "fused_obs_leg") for f in ("f32", "f64")
    },
    # B2: jac, g0, d1, d2, vc, cpos, slots, starts, work, h_ll, g_l, w,
    # rows, n, s, n_work, l_total, n_r, n_rows, dr_s, dl, e_start, then the
    # element strides jsn, jss, gss, gk, stream
    "fused_obs_all_into_f32": [_P] * 13 + [_I] * 9 + [_LL] * 4 + [_P],
    "fused_obs_all_into_f64": [_P] * 13 + [_I] * 9 + [_LL] * 4 + [_P],
    # B3 (float32 only), B4 and B5 (the external instance): w, h_ll or
    # h_inv ([dl, dl, L]; past dl 6 [L, dl, dl]), g_l, lam (B3: a device
    # double; NULL otherwise), the tables
    # lmk, blk, bcol, bwidth, pairs, links, items, istarts, the scratch yc,
    # wb, part, rpart, s_sum, rhs_sum, h_inv (B3; NULL otherwise), l, dl,
    # wc, widest block, padded block, n_inc, n_items, n_pairs, uniform
    # (every block mw wide from column 0), stream
    **{
        name: [_P] * 19 + [_I] * 9 + [_P]
        for name in ("reduce_s_damped_f32", "reduce_s_external_f32", "reduce_s_external_f64")
    },
    # we, lstarts, colbase, w, n, l, dl, dr_s, wc, stream
    "place_w_f32": [_P] * 4 + [_LL] + [_I] * 4 + [_P],
    "place_w_f64": [_P] * 4 + [_LL] + [_I] * 4 + [_P],
    # data, starts, out, part, n, l, d, rows per chunk, stream
    **{
        f"segment_block_sum_{f}_{i}": [_P] * 4 + [_LL, _I, _I, _I, _P]
        for f in ("f32", "f64") for i in ("i32", "i64")
    },
}

_lib = None
#: nvcc's output of the build this process ran (``-Xptxas -v``: registers,
#: shared memory and spills per kernel); empty when the library was reused.
BUILD_LOG = ""
#: Seconds the build this process ran took (nvcc and link), 0.0 when the
#: library was reused.
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (torch.utils.cpp_extension.CUDA_HOME="
            f"{CUDA_HOME!r}); the port's kernels build with the CUDA toolkit"
        )
    return nvcc


def _check_nvcc(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{log}")


def library():
    """The loaded kernel library, built on first call."""
    global _lib, BUILD_LOG, BUILD_SECONDS
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = _OUT / f"libnllstpu_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _OUT.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [so.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in sources]
        jobs = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in jobs
        ]
        logs = [pr.communicate()[0] for pr in procs]
        BUILD_LOG = "".join(logs)
        for cmd, pr, log in zip(jobs, procs, logs):
            _check_nvcc(cmd, pr.returncode, log)
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
        pr = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, pr.returncode, pr.stdout + pr.stderr)
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
