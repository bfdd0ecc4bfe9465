"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch header is included, so a cold build
takes seconds rather than minutes, and no ``ninja`` is needed.  The library lands in
``.torch_ext/`` at the repository root under a name that hashes the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The build runs at first use, never at import; a failed build
raises.  nvcc's report of each kernel's registers and spill (``-Xptxas
-v``) is kept beside the library and read by :func:`resources`.

Each exported launcher enqueues on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch (0 = success).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import time

from ..utils import profiling

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
    # The any-shape instance's shared memory a block: n, dr_s, dl, f64
    "fused_obs_any_bytes": [_I] * 4,
    "fused_obs_any_warps": [_I] * 4,
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
#: The loaded library's path.
_so = None


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
    global _lib, _so, BUILD_LOG, BUILD_SECONDS
    if _lib is not None:
        return _lib
    with profiling.setup_span("nt.compile.build"):
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
            so.with_suffix(".log").write_text(BUILD_LOG)
            os.replace(tmp, so)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    _lib, _so = lib, so
    return lib


def resources(log=None):
    """``[(kernel, registers, spill store bytes, spill load bytes)]`` of
    every kernel in ``log`` (nvcc's ``-Xptxas -v`` output; default: the
    loaded library's build, kept beside it), in the log's order, names
    demangled by the toolkit's ``cu++filt`` where it runs."""
    if log is None:
        path = _so.with_suffix(".log") if _so is not None else None
        log = path.read_text() if path is not None and path.exists() else ""
    regs, spill, order = {}, {}, []
    entry = props = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
            if entry not in regs:
                order.append(entry)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill[props] = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry is not None:
            regs[entry] = int(m.group(1))
    names = order
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        filt = os.path.join(CUDA_HOME or "", "bin", "cu++filt")
        out = subprocess.run([filt], input="\n".join(order), capture_output=True, text=True,
                             timeout=30).stdout.splitlines()
        if len(out) == len(order):
            names = out
    except (OSError, subprocess.SubprocessError):
        pass
    return [(name, regs.get(k, 0), *spill.get(k, (0, 0))) for name, k in zip(names, order)]


def check(code: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
