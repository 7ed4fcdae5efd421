"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles ``falcon_tpu_torch/csrc/*.cu`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The library lands in ``falcon_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, so a changed source
is rebuilt and an unchanged one is reused.  Nothing is built or imported
when this module is imported: the CPU tests import every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    # mz_rows, int_rows, n_rows, mz_cols, int_cols, n_cols, row_offset,
    # tol, rounds, upper_only, scores, matches, stream
    "falcon_panel_scores": [_p, _p, _i, _p, _p, _i, _ll, _f, _i, _i, _p,
                            _p, _p],
    # mz, intensity, starts, pair_starts, n_groups, n_pairs, tol, rounds,
    # scores, matches, stream
    "falcon_grouped_scores": [_p, _p, _p, _p, _i, _ll, _f, _i, _p, _p, _p],
}


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build "
        f"{CSRC_DIR}"
    )


def library_path() -> str:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(
        BUILD_DIR, f"libfalcon_tpu_torch_{digest.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", tmp]
           + [s for s in _sources() if s.endswith(".cu")])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.isfile(path):
                start = time.perf_counter()
                _compile(path)
                build_seconds = time.perf_counter() - start
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
