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
                                             "behz.cu", "keyswitch.cu",
                                             "rlwe.cu", "elementwise.cu",
                                             "mesh.cu")]
HEADERS = [os.path.join(_CSRC, f) for f in ("ntt_common.cuh",
                                             "ntt_passes.cuh",
                                             "rns_common.cuh")]
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


def build(csrc: str = _CSRC, so: str = _SO) -> None:
    """Compile SOURCES (one nvcc each, started together; from another
    directory `csrc` of the same files, such as a variant of them) and link
    them into the shared library `so` (atomically replaced, so concurrent
    processes never load a half-written file)."""
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    sources = [os.path.join(csrc, os.path.basename(src)) for src in SOURCES]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources]
    tmp = f"{so}.{tag}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        build_log = "".join(logs)
        bad = [(src, p.returncode) for src, p in zip(sources, procs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError(f"nvcc failed on {bad}:\n{build_log}")
        link = subprocess.run([nvcc] + ARCH + ["-shared", "-o", tmp] + objs,
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, so)
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
    _LIB = open_library(_SO)
    return _LIB


def open_library(so: str) -> ctypes.CDLL:
    """A build of SOURCES at `so`, bound and initialised as `load` binds
    this package's (a variant's build, loaded beside it, is what
    scripts/replay_ab.py swaps in)."""
    lib = ctypes.CDLL(so)
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
    bind_keyswitch(lib)
    bind_rlwe(lib)
    bind_elementwise(lib)
    bind_mesh(lib)
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
    return lib


def launch(counts: dict, name: str, device, call) -> None:
    """call(lib, stream) on `device`'s current stream, the launch of kernel
    `name` through the library's C entry point; raises on the error code
    it returns, else adds one to counts[name] (the BEHZ and key-switch
    wrappers' `launches`)."""
    import torch
    lib = load()
    with torch.cuda.device(device):
        err = call(lib, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    counts[name] += 1


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


def bind_keyswitch(lib: ctypes.CDLL) -> None:
    """The argument and return types of the key-switch kernels' C entry
    points (csrc/keyswitch.cu) on a library that holds them."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.abc_ks_decompose.argtypes = [vp] * 5 + [i64, i64] + [i32] * 5 + [vp]
    lib.abc_ks_contract.argtypes = [vp] * 7 + [i64, i64] + [i32] * 3 + [vp]
    lib.abc_ks_mod_down.argtypes = [vp] * 3 + [i64, i64] + [i32] * 3 + [vp]
    # ..., tail, c, c_stride, c_comp, g^-1 mod 2n, stream
    lib.abc_ks_mod_down_tail.argtypes = [vp] * 3 + [i64, i64] + [i32] * 4 + \
        [vp, i64, i64, i64, vp]
    lib.abc_ks_mod_down_plan.argtypes = [i32, i64] + [i32] * 3 + [vp]
    lib.abc_ks_plan.argtypes = [i32, i64] + [i32] * 5 + [vp]
    for fn in (lib.abc_ks_decompose, lib.abc_ks_contract, lib.abc_ks_mod_down,
               lib.abc_ks_mod_down_tail, lib.abc_ks_mod_down_plan,
               lib.abc_ks_plan):
        fn.restype = i32


def bind_elementwise(lib: ctypes.CDLL) -> None:
    """The argument and return types of the RNS elementwise kernel's C entry
    points (csrc/elementwise.cu) on a library that holds them."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    operand = [vp] + [i64] * 4
    lib.abc_rns_ew.argtypes = [i32] + operand * 2 + [i32] + [vp] * 4 + \
        [i64] + [i32] * 4 + [vp]
    lib.abc_ew_launch_info.argtypes = [i32, i64, i32, vp]
    for fn in (lib.abc_rns_ew, lib.abc_ew_launch_info):
        fn.restype = i32


def bind_mesh(lib: ctypes.CDLL) -> None:
    """The argument and return types of the mesh kernels' C entry points
    (csrc/mesh.cu) on a library that holds them."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    view = [vp] + [i64] * 3
    lib.abc_dist_ntt_combine.argtypes = [i32] + view * 2 + [i32] + view + \
        [vp, vp, i64] + [vp] * 3 + [i64] + [i32] * 5 + [vp]
    lib.abc_rns_psum_mod.argtypes = [i32] + view + [vp, i64, i64, vp, i64] + \
        [i32] * 3 + [vp]
    for fn in (lib.abc_dist_ntt_combine, lib.abc_rns_psum_mod):
        fn.restype = i32


def bind_rlwe(lib: ctypes.CDLL) -> None:
    """The argument and return types of the key generation, encryption and
    decryption kernels' C entry points (csrc/rlwe.cu) on a library that
    holds them."""
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32)
    lib.abc_rns_uniform.argtypes = [vp] * 4 + [i64, i32, i32, vp]
    lib.abc_ksk_compose.argtypes = [vp] * 10 + [i64, i32, i32, i32, vp]
    lib.abc_rlwe_lift.argtypes = [vp] * 6 + [i64, i32, i32, vp]
    lib.abc_bfv_dec_round.argtypes = [vp] * 4 + [i64, i64, i32, u32, i32,
                                                 vp]
    lib.abc_rlwe_plan.argtypes = [i32, i64, i32, i32, vp]
    for fn in (lib.abc_rns_uniform, lib.abc_ksk_compose, lib.abc_rlwe_lift,
               lib.abc_bfv_dec_round, lib.abc_rlwe_plan):
        fn.restype = i32


def sass() -> str:
    """The library's SASS as `cuobjdump -sass` prints it (built first if
    needed)."""
    load()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", _SO], capture_output=True,
                          text=True, check=True).stdout
