"""Build and load the CUDA kernels of this package (csrc/*.cu).

Each source is compiled at first use with `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), all sources at once in parallel,
and linked into one shared library with a plain C interface under
`abc_tpu_torch/_build/`, loaded with ctypes: no PyTorch headers are
compiled, so a build takes seconds. A missing `nvcc` or a failed compile
raises; there is no fallback. The in-repo model for this pattern is
abc_tpu/ops/native.py.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = [os.path.join(_CSRC, f) for f in ("ntt.cu", "ntt_ablation.cu",
                                             "behz.cu")]
HEADERS = [os.path.join(_CSRC, f) for f in ("ntt_common.cuh",
                                             "ntt_passes.cuh")]
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libabc_ntt.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

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
    return any(os.path.getmtime(src) > built for src in SOURCES + HEADERS)


def build() -> None:
    """Compile SOURCES (one nvcc each, started together) and link them into
    the shared library (atomically replaced, so concurrent processes never
    load a half-written file)."""
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in SOURCES]
    tmp = f"{_SO}.{tag}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        build_log = "".join(logs)
        bad = [(src, p.returncode) for src, p in zip(SOURCES, procs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError(f"nvcc failed on {bad}:\n{build_log}")
        link = subprocess.run([nvcc] + ARCH + ["-shared", "-o", tmp] + objs,
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, _SO)
    finally:
        for path in objs:
            if os.path.exists(path):
                os.remove(path)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or older than a source,
    with every kernel allowed the shared memory its largest launch takes."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if _stale():
        build()
    lib = ctypes.CDLL(_SO)
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32)
    lib.abc_ntt_fwd.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.abc_ntt_fwd.restype = i32
    lib.abc_ntt_inv.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.abc_ntt_inv.restype = i32
    lib.abc_ntt_cluster_size.argtypes = [i64, i32]
    lib.abc_ntt_cluster_size.restype = i32
    lib.abc_ablate_ntt.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.abc_ablate_ntt.restype = i32
    lib.abc_alu_chain.argtypes = [vp, vp, i64, i32, u32, u32, u32, i32, vp]
    lib.abc_alu_chain.restype = i32
    bind_behz(lib)
    lib.abc_behz_launch_info.argtypes = [i32, i32, i32, i64, i32, vp]
    lib.abc_behz_launch_info.restype = i32
    lib.abc_cuda_error_string.argtypes = [i32]
    lib.abc_cuda_error_string.restype = ctypes.c_char_p
    # the kernels' shared-memory limit, set once (csrc/ntt_passes.cuh:
    # allow_max_smem)
    for init in (lib.abc_ntt_init, lib.abc_ablate_init):
        init.argtypes, init.restype = [], i32
        err = init()
        if err != 0:
            raise RuntimeError(f"{init.__name__} failed: "
                               f"{lib.abc_cuda_error_string(err).decode()}")
    _LIB = lib
    return lib


def bind_behz(lib: ctypes.CDLL) -> None:
    """The argument and return types of the BEHZ kernels' C entry points
    (csrc/behz.cu) on a library that holds them. A build of an earlier
    commit may hold the one-base abc_behz_tensor in place of
    abc_behz_tensor_bases: scripts/behz_ab.py binds that one itself."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for conv in (lib.abc_behz_to_bsk, lib.abc_behz_from_bsk):
        conv.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
        conv.restype = i32
    lib.abc_behz_fast_floor.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                        vp]
    lib.abc_behz_fast_floor.restype = i32
    if hasattr(lib, "abc_behz_tensor_bases"):
        # per base: f1, f2, out, q, ratio, rows1, rows2, D; logn, stream
        lib.abc_behz_tensor_bases.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                              i32] * 2 + [i32, vp]
        lib.abc_behz_tensor_bases.restype = i32


def sass() -> str:
    """The library's SASS as `cuobjdump -sass` prints it (built first if
    needed)."""
    load()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", _SO], capture_output=True,
                          text=True, check=True).stdout
