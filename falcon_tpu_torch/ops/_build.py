"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles each ``falcon_tpu_torch/csrc/*.cu`` for
Hopper (``sm_90a``), all sources at once in parallel processes, and links
the objects into one shared library with a plain C interface, which is
loaded with ``ctypes``.  ``build_log`` keeps what ``-Xptxas -v`` said about
each kernel (registers, shared memory, spills).  The library lands in
``falcon_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.  Nothing is built or imported
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = ""  # the compilers' messages of that build

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    # mz_rows, int_rows, n_rows, mz_cols, int_cols, n_cols, row_offset,
    # tol, rounds, upper_only, scores, matches, stream
    "falcon_panel_scores": [_p, _p, _i, _p, _p, _i, _ll, _f, _i, _i, _p,
                            _p, _p],
    # mz, intensity, n, sorted, starts, layout, n_groups, n_items, tol,
    # rounds, scores, matches, stream
    "falcon_grouped_scores": [_p, _p, _i, _p, _p, _p, _i, _ll, _f, _i, _p,
                              _p, _p],
    # mz_rows, int_rows, n_rows, mz_pool, int_pool, starts, pass_offset,
    # window, tol, rounds, scores, matches, stream
    "falcon_banded_scores": [_p, _p, _i, _p, _p, _p, _ll, _i, _f, _i, _p,
                             _p, _p],
    # mz_q, int_q, n_q, mz_pool, int_pool, ids, k, tol, rounds, scores,
    # matches, stream
    "falcon_pair_list_scores": [_p, _p, _i, _p, _p, _p, _i, _f, _i, _p,
                                _p, _p],
    # mz, intensity, n, mapping, n_bins, min_bound, inv_bin, dim, norm,
    # out_plain, out_spread, stream
    "falcon_vectorize": [_p, _p, _i, _p, _i, _f, _f, _i, _i, _p, _p, _p],
    # sims, neigh, seg, n_pad, k, spill, w, tgt, rowsum, cnt1, stream
    "falcon_medoid_weights": [_p, _p, _p, _i, _i, _i, _p, _p, _p, _p, _p],
    # w, items, off, rowsum, n_pad, k, chunk, out, stream
    "falcon_medoid_sums": [_p, _p, _p, _p, _i, _i, _i, _p, _p],
    # v, dim, items, off, n_seg, sums, stream
    "falcon_hashed_medoid_sums": [_p, _i, _p, _p, _i, _p, _p],
    # v, dim, seg, n, spill, sums, out, stream
    "falcon_hashed_medoid_dot": [_p, _i, _p, _i, _i, _p, _p, _p],
    # key, n, shift, n_groups, cnt1, stream
    "falcon_groupby_count": [_p, _i, _i, _i, _p, _p],
    # key, n, shift, n_groups, off, cnt1, items, stream
    "falcon_groupby_fill": [_p, _i, _i, _i, _p, _p, _p, _p],
    # off, n_groups, items, stream
    "falcon_groupby_order": [_p, _i, _p, _p],
    # key, member, mz, intensity, items, off, n_buckets, key_tmp, int_tmp,
    # mzint_tmp, members_tmp, kcnt1, stream
    "falcon_consensus_walk": [_p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p,
                              _p, _p],
    # off, koff, n_buckets, key_tmp, int_tmp, mzint_tmp, members_tmp,
    # keys_out, int_sum, mzint_sum, members, stream
    "falcon_consensus_compact": [_p, _p, _i, _p, _p, _p, _p, _p, _p, _p, _p,
                                 _p],
    # q, c, qmz, qrow, cmz, crow, probe_ids, qlb, lb, dim, n_probe, c0,
    # chunk, tol, tol_is_da, bf16, k, count, seg, out_s, out_i, stream
    "falcon_ivf_probe_topk": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                              _i, _f, _i, _i, _i, _p, _p, _p, _p, _p],
    # assign, n, n_lists, tile, cnt1, stream
    "falcon_kmeans_count": [_p, _i, _i, _i, _p, _p],
    # assign, n, n_lists, tile, off, items, stream
    "falcon_kmeans_fill": [_p, _i, _i, _i, _p, _p, _p],
    # v, dim, items, off, n_lists, n_tiles, old, out, stream
    "falcon_kmeans_centroids": [_p, _i, _p, _p, _i, _i, _p, _p, _p],
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


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's
    command and messages; return everything they printed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(out: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    sources = [s for s in _sources() if s.endswith(".cu")]
    objects = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    try:
        log = _run([[nvcc] + NVCC_FLAGS + ["-c", "-o", o, s]
                    for s, o in zip(sources, objects)])
        log += _run([[nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp]
                     + objects])
    finally:
        for o in objects:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.isfile(path):
                start = time.perf_counter()
                build_log = _compile(path)
                build_seconds = time.perf_counter() - start
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
