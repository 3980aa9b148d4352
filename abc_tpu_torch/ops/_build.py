"""Build and load the CUDA kernels of this package (csrc/*.cu).

The sources are compiled at first use with `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a plain
C interface under `abc_tpu_torch/_build/`, and loaded with ctypes: no
PyTorch headers are compiled, so a build takes seconds. A missing `nvcc` or
a failed compile raises; there is no fallback. The in-repo model for this
pattern is abc_tpu/ops/native.py.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", "ntt.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libabc_ntt.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
# what the last build in this process printed and how long it took
build_log = ""
build_seconds = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of abc_tpu_torch "
                       "are built from csrc/ at first use and need the CUDA "
                       "toolkit")


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(os.path.getmtime(src) > built for src in SOURCES)


def build() -> None:
    """Compile SOURCES into the shared library (atomically replaced, so
    concurrent processes never load a half-written file)."""
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + SOURCES
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, _SO)


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or older than a source."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if _stale():
        build()
    lib = ctypes.CDLL(_SO)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.abc_ntt_fwd.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.abc_ntt_fwd.restype = i32
    lib.abc_ntt_inv.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.abc_ntt_inv.restype = i32
    lib.abc_cuda_error_string.argtypes = [i32]
    lib.abc_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
