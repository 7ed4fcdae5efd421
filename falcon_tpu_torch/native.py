"""ctypes bindings for the first-party native host library.

Copy of ``falcon_tpu/native.py`` for the port, apart from where the library
comes from.  ``native/falcon_native.cc`` (this package's own copy of the
sources, beside this module) provides the sequential host-side algorithms
(SURVEY.md §2.3): nearest-neighbor-chain agglomerative linkage (replacing
fastcluster), distance-threshold tree cuts (replacing
``scipy.cluster.hierarchy.fcluster``), and union-find connected components
for density clustering, plus the native ingest and export paths.

The shared library is built at first use with the flags of the JAX
package's ``native/Makefile``, one ``g++`` per source in parallel, into
``falcon_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so a changed source is rebuilt.  Processes that need it at once (test
workers, ingest workers) serialise on a file lock, and the library is
written under a temporary name and renamed into place, so no process loads
a half-written file.  If the toolchain is unavailable, a SciPy fallback
keeps the pipeline functional (used only as a fallback — the native path is
the product).
"""

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("falcon_tpu")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("falcon_native.cc", "falcon_ingest.cc", "falcon_mzml.cc")
_HEADERS = ("falcon_ascii.h",)
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]

_METHODS = {"single": 0, "complete": 1, "average": 2}

_lib = None
_lib_lock = threading.Lock()


class ExportVisit(ctypes.Structure):
    """One visit of an export tie group, as ``falcon_native.cc`` reads it:
    the rows one shard holds of the group's files, columns in place."""

    _fields_ = [
        ("n", ctypes.c_int64),
        ("filename", ctypes.c_void_p),
        ("filename_width", ctypes.c_int64),
        ("filename_const", ctypes.c_int64),
        ("id", ctypes.c_void_p),
        ("id_width", ctypes.c_int64),
        ("charge", ctypes.c_void_p),
        ("mz", ctypes.c_void_p),
        ("mz_f32", ctypes.c_int64),
        ("rt", ctypes.c_void_p),
        ("rt_f32", ctypes.c_int64),
        ("cluster", ctypes.c_void_p),
    ]


def library_path() -> str:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for name in _SOURCES + _HEADERS:
        digest.update(name.encode())
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(
        _BUILD_DIR, f"libfalcon_native_{digest.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    """Compile the sources into ``out``; raise on a failed command."""
    tmp = f"{out}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{name}.o" for name in _SOURCES]
    try:
        procs = [
            subprocess.Popen(
                ["g++"] + _CXXFLAGS + ["-c", "-o", obj,
                                       os.path.join(_SRC_DIR, name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for name, obj in zip(_SOURCES, objects)
        ]
        for proc in procs:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                raise subprocess.CalledProcessError(
                    proc.returncode, proc.args, output)
        subprocess.run(["g++"] + _CXXFLAGS + ["-shared", "-o", tmp]
                       + objects + ["-lz"], check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        for path in objects + [tmp]:
            if os.path.exists(path):
                os.remove(path)


def _build(path: str) -> bool:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isfile(path):  # another process may have built it
                _compile(path)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        logger.warning("Could not build native library: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib
    if _lib is not None:
        return _lib or None
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        path = library_path()
        if not os.path.isfile(path) and not _build(path):
            _lib = False
            return None
        lib = ctypes.CDLL(path)
        lib.fc_linkage.restype = ctypes.c_int
        lib.fc_linkage.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ]
        lib.fc_fcluster.restype = ctypes.c_int64
        lib.fc_fcluster.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fc_link_components.restype = ctypes.c_int64
        lib.fc_link_components.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fc_connected_components.restype = ctypes.c_int64
        lib.fc_connected_components.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fc_mgf_ingest.restype = ctypes.c_void_p
        lib.fc_mgf_ingest.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        if hasattr(lib, "fc_mgf_ingest_range"):
            lib.fc_mgf_ingest_range.restype = ctypes.c_void_p
            lib.fc_mgf_ingest_range.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
            ]
        lib.fc_mgf_result_copy.restype = ctypes.c_int
        lib.fc_mgf_result_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char),
        ]
        lib.fc_mgf_result_free.restype = None
        lib.fc_mgf_result_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "fc_result_n_unsupported"):
            lib.fc_result_n_unsupported.restype = ctypes.c_int64
            lib.fc_result_n_unsupported.argtypes = [ctypes.c_void_p]
        for entry in ("fc_result_n_topn", "fc_result_title_width"):
            getattr(lib, entry).restype = ctypes.c_int64
            getattr(lib, entry).argtypes = [ctypes.c_void_p]
        lib.fc_result_group_by_charge.restype = None
        lib.fc_result_group_by_charge.argtypes = [ctypes.c_void_p]
        lib.fc_result_titles_u32.restype = ctypes.c_int
        lib.fc_result_titles_u32.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
        ]
        for entry in ("fc_mzml_ingest", "fc_mzxml_ingest",
                      "fc_msp_ingest"):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_void_p
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64),
                ]
        for entry in ("fc_mzml_ingest_range", "fc_mzxml_ingest_range",
                      "fc_msp_ingest_range"):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_void_p
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_double,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64),
                ]
        lib.fc_natsort_visits.restype = ctypes.c_int
        lib.fc_natsort_visits.argtypes = [
            ctypes.POINTER(ExportVisit), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.fc_export_rows.restype = ctypes.c_int64
        lib.fc_export_rows.argtypes = [
            ctypes.c_int, ctypes.POINTER(ExportVisit), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return lib


def _as_double_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _n_from_condensed(m: int) -> int:
    n = int(round((1 + np.sqrt(1 + 8 * m)) / 2))
    if n * (n - 1) // 2 != m:
        raise ValueError(f"invalid condensed matrix length {m}")
    return n


def linkage(condensed: np.ndarray, method: str) -> np.ndarray:
    """Agglomerative linkage on a condensed distance matrix.

    Returns the (n-1, 4) scipy-format linkage (rows sorted by distance).
    Reference behavior: ``fastcluster.linkage(pdist, linkage)``
    (``falcon/cluster/cluster.py:285``).
    """
    if method not in _METHODS:
        raise ValueError(f"unsupported linkage method {method!r}")
    n = _n_from_condensed(len(condensed))
    lib = get_lib()
    if lib is None:
        import scipy.cluster.hierarchy as sch

        return sch.linkage(condensed, method)
    # Exactly one copy: fc_linkage destroys its input, so aliasing the
    # caller's array is unsafe, but ascontiguousarray(...).copy() paid a
    # second ~2.1 GB copy at the interval cap whenever a dtype
    # conversion already copied.
    work = np.array(condensed, np.float64, order="C", copy=True)
    z = np.empty((n - 1, 4), np.float64)
    rc = lib.fc_linkage(
        _as_double_ptr(work), ctypes.c_int64(n),
        ctypes.c_int(_METHODS[method]), _as_double_ptr(z),
    )
    if rc == 2:
        # Same contract as scipy: a non-finite distance has no defined
        # merge order (and would corrupt the NN-chain walk in C++).
        raise ValueError(
            "linkage requires a finite condensed distance matrix "
            "(found NaN or infinity)")
    if rc != 0:
        raise RuntimeError(f"fc_linkage failed with code {rc}")
    return z


def fcluster(z: np.ndarray, t: float, n: Optional[int] = None) -> np.ndarray:
    """Flat clusters from a linkage via a distance-threshold cut.

    0-based labels grouped exactly as scipy's
    ``fcluster(Z, t, "distance")`` for monotone linkages (reference call
    sites ``falcon/cluster/cluster.py:283-290, 413-421``; the reference
    subtracts 1 from scipy's 1-based labels).
    """
    if n is None:
        n = z.shape[0] + 1
    lib = get_lib()
    if lib is None:
        import scipy.cluster.hierarchy as sch

        return (sch.fcluster(z, t, "distance") - 1).astype(np.int32)
    z = np.ascontiguousarray(z, np.float64)
    labels = np.empty(n, np.int32)
    k = lib.fc_fcluster(
        _as_double_ptr(z), ctypes.c_int64(n), ctypes.c_double(t),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if k < 0:
        raise ValueError(
            "fcluster got an invalid linkage matrix (non-finite or "
            "out-of-range cluster ids)")
    return labels


def far_threshold(eps: float) -> float:
    """The float64 threshold above which a float32 distance reads as
    ``> eps`` to NumPy, which compares a float32 scalar with a Python float
    in float32 (NumPy 2) or in float64 (NumPy 1)."""
    eps32 = np.float32(eps)
    if float(eps32) > eps and not eps32 > eps:
        return float(eps32)
    return float(eps)


def link_components(dist: np.ndarray, comps: np.ndarray,
                    member_off: np.ndarray, mz: np.ndarray,
                    rt: Optional[np.ndarray], ids: np.ndarray, method: str,
                    eps: float, tol_mass: float, tol_mode: str,
                    rt_tol: Optional[float], labels: np.ndarray,
                    n_clusters: np.ndarray, medoids: np.ndarray,
                    n_medoids: np.ndarray, eps_far: float) -> Optional[int]:
    """``cluster.postprocess.link_component`` on each component of
    ``comps`` in one call with the interpreter lock released
    (``fc_link_components``); None when the library is unavailable.

    ``dist``: the components' condensed float32 distances, one after the
    other.  Component c's members are rows ``member_off[c]`` to
    ``member_off[c + 1]`` of ``mz``, ``rt`` (read only with ``rt_tol``)
    and ``ids``.  Writes each member's label at its row of ``labels`` (from
    0 within its component), the component's medoids from its first row of
    ``medoids`` on, and its counts at ``n_clusters[c]``, ``n_medoids[c]``.
    A component closes whole when no distance is above ``eps_far``.
    Returns the number of components closed whole."""
    if method not in _METHODS:
        raise ValueError(f"unsupported linkage method {method!r}")
    lib = get_lib()
    if lib is None:
        return None
    dist = np.ascontiguousarray(dist, np.float32)
    comps = np.ascontiguousarray(comps, np.int64)
    if len(comps) and (comps.min() < 0 or comps.max() >= len(member_off) - 1):
        raise ValueError("link_components: a component id out of range")
    sizes = member_off[comps + 1] - member_off[comps]
    if len(dist) != int((sizes * (sizes - 1) // 2).sum()):
        raise ValueError("link_components: the distances do not cover the "
                         "components' pairs")
    n = len(ids)
    for name, arr, dtype in (
            ("member_off", member_off, np.int64), ("mz", mz, np.float64),
            ("ids", ids, np.int64), ("labels", labels, np.int32),
            ("medoids", medoids, np.int64),
            ("n_clusters", n_clusters, np.int64),
            ("n_medoids", n_medoids, np.int64)) + (
            (("rt", rt, np.float64),) if rt_tol is not None else ()):
        if arr.dtype != dtype or not arr.flags.c_contiguous:
            raise ValueError(f"link_components: {name} must be contiguous "
                             f"{np.dtype(dtype).name}")
    if (len(mz) != n or len(labels) != n or len(medoids) != n
            or member_off[-1] > n
            or (rt_tol is not None and len(rt) != n)):
        raise ValueError("link_components: member arrays differ in length")

    def ptr(a, c_type):
        return a.ctypes.data_as(ctypes.POINTER(c_type))

    rc = lib.fc_link_components(
        ptr(dist, ctypes.c_float), ctypes.c_int64(len(dist)),
        ptr(comps, ctypes.c_int64), ctypes.c_int64(len(comps)),
        ptr(member_off, ctypes.c_int64), _as_double_ptr(mz),
        _as_double_ptr(rt) if rt_tol is not None else None,
        ptr(ids, ctypes.c_int64), ctypes.c_int(_METHODS[method]),
        ctypes.c_double(eps), ctypes.c_double(eps_far),
        ctypes.c_double(tol_mass), ctypes.c_int(tol_mode == "ppm"),
        ctypes.c_double(0.0 if rt_tol is None else rt_tol),
        ptr(labels, ctypes.c_int32), ptr(n_clusters, ctypes.c_int64),
        ptr(medoids, ctypes.c_int64), ptr(n_medoids, ctypes.c_int64))
    if rc == -2:
        raise ValueError(
            "linkage requires a finite condensed distance matrix "
            "(found NaN or infinity)")
    if rc < 0:
        raise RuntimeError(f"fc_link_components failed with code {rc}")
    return int(rc)


_NULL_CHARGE_I32 = -(2**31)  # C++ kNullCharge sentinel
_SCALING_CODES = {None: 0, "off": 0, "root": 1, "log": 2, "rank": 3}


def mgf_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
    by_charge: bool = False,
) -> Optional[dict]:
    """Parse + preprocess an entire MGF file in the native library.

    ``start``/``end`` select a byte range: the call parses exactly the
    spectra whose BEGIN IONS line starts in ``[start, end)``, so
    arbitrary byte splits concatenate to the whole-file parse (the
    parallel single-file ingest path, ``ingest.py``).  The C call
    releases the GIL, so ranges of one file parse concurrently from a
    thread pool.  Every call (ranged or not) re-reads the file head for
    MGF header params (merged into each spectrum, local keys winning);
    the header scan is capped at 1 MB (SURVEY.md §3.5).

    Returns a columnar batch (same preprocessing semantics as
    ``preprocess.process_spectrum`` over ``ms_io.get_spectra``; parity
    enforced by tests/test_native_ingest.py)::

        {"identifier": unicode (n,), "precursor_mz": f64 (n,),
         "precursor_charge": i32 (n,) with _NULL_CHARGE_I32 for None,
         "retention_time": f64 (n,), "peak_offsets": i64 (n+1,),
         "mz": f32 flat, "intensity": f32 flat,
         "n_read": int, "n_low_quality": int,
         "n_topn": spectra the intensity filter cut to max_peaks_used,
         "titles_fallback": whether the identifiers were decoded in
         Python (a title that is not well-formed UTF-8)}

    or None when the native library (or the file) is unavailable — the
    caller falls back to the Python path.  ``by_charge`` orders the rows
    by store charge (``store.charge16``), each charge's rows in file order,
    as ``store.RunPlan`` takes them.
    """
    return _native_ingest(filename, "fc_mgf_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end,
                          by_charge=by_charge)


def mzml_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
    by_charge: bool = False,
) -> Optional[dict]:
    """Parse + preprocess an entire mzML file in the native library
    (``native/falcon_mzml.cc``); same batch contract as
    :func:`mgf_ingest`.  A truncated document additionally sets
    ``batch["truncated"] = True`` so the caller can warn like the
    Python reader does.  ``start``/``end`` select a byte range (block
    ownership by ``<spectrum`` open-tag offset, so arbitrary splits
    concatenate to the whole-file parse; the GIL is released during
    the C call)."""
    return _native_ingest(filename, "fc_mzml_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end,
                          by_charge=by_charge)


def mzxml_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
    by_charge: bool = False,
) -> Optional[dict]:
    """Parse + preprocess an entire mzXML file in the native library
    (``native/falcon_mzml.cc``); same batch contract as
    :func:`mgf_ingest` (+ ``truncated`` flag and ``start``/``end``
    byte-range selection, as for mzML — ownership by each ``<scan``
    open tag's own offset, nested MS2 scans included)."""
    return _native_ingest(filename, "fc_mzxml_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end,
                          by_charge=by_charge)


def msp_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
    by_charge: bool = False,
) -> Optional[dict]:
    """Parse + preprocess an entire MSP spectral library in the native
    library (``native/falcon_ingest.cc``, mirroring
    ``ms_io/msp_io.py``); same batch contract as :func:`mgf_ingest`,
    including ``start``/``end`` byte-range selection (ownership by each
    ``Name:`` line's offset, so arbitrary splits concatenate to the
    whole-file parse)."""
    return _native_ingest(filename, "fc_msp_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end,
                          by_charge=by_charge)


def _native_ingest(filename, entry, min_peaks, min_mz_range, mz_min,
                   mz_max, remove_precursor_tolerance, min_intensity,
                   max_peaks_used, scaling, start=None, end=None,
                   by_charge=False) -> Optional[dict]:
    lib = get_lib()
    if lib is None or not hasattr(lib, entry):
        return None
    is_xml = entry in ("fc_mzml_ingest", "fc_mzxml_ingest")
    range_args = ()
    if start is not None or end is not None:
        entry += "_range"
        range_args = (ctypes.c_int64(start or 0),
                      ctypes.c_int64(-1 if end is None else end))
    counts = (ctypes.c_int64 * 7)()
    nan = float("nan")
    handle = getattr(lib, entry)(
        os.fsencode(filename),
        *range_args,
        ctypes.c_int(min_peaks),
        ctypes.c_double(min_mz_range),
        ctypes.c_double(nan if mz_min is None else mz_min),
        ctypes.c_double(nan if mz_max is None else mz_max),
        ctypes.c_double(
            nan if remove_precursor_tolerance is None
            else remove_precursor_tolerance
        ),
        ctypes.c_double(nan if min_intensity is None else min_intensity),
        ctypes.c_int(0 if max_peaks_used is None else max_peaks_used),
        ctypes.c_int(_SCALING_CODES[scaling]),
        counts,
    )
    if not handle:
        return None
    try:
        n, n_peaks, title_bytes, n_read, n_low_quality = (
            int(counts[i]) for i in range(5)
        )
        truncated = bool(counts[5]) if is_xml else False
        n_blocks = int(counts[6])
        if by_charge:
            lib.fc_result_group_by_charge(handle)
        precursor_mz = np.empty(n, np.float64)
        charge = np.empty(n, np.int32)
        rt = np.empty(n, np.float64)
        peak_offsets = np.empty(n + 1, np.int64)
        mz = np.empty(n_peaks, np.float32)
        intensity = np.empty(n_peaks, np.float32)
        title_offsets = np.empty(n + 1, np.int64)
        titles = ctypes.create_string_buffer(max(title_bytes, 1))
        rc = lib.fc_mgf_result_copy(
            handle,
            _as_double_ptr(precursor_mz),
            charge.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _as_double_ptr(rt),
            peak_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            mz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            title_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            titles,
        )
        if rc != 0:
            raise RuntimeError("fc_mgf_result_copy failed")
        identifiers = _identifiers(lib, handle, n)
        titles_fallback = identifiers is None
        if titles_fallback:
            raw = titles.raw[:title_bytes]
            identifiers = np.array([
                raw[title_offsets[i]:title_offsets[i + 1]].decode(
                    "utf-8", "replace")
                for i in range(n)
            ])
        n_unsupported = int(lib.fc_result_n_unsupported(handle))
        n_topn = int(lib.fc_result_n_topn(handle))
    finally:
        lib.fc_mgf_result_free(handle)
    return {
        "identifier": identifiers,
        "precursor_mz": precursor_mz,
        "precursor_charge": charge,
        "retention_time": rt,
        "peak_offsets": peak_offsets,
        "mz": mz,
        "intensity": intensity,
        "n_read": n_read,
        "n_low_quality": n_low_quality,
        "truncated": truncated,
        "n_blocks": n_blocks,
        # Spectra skipped for unsupported binary compression (numpress
        # etc.); ingest warns so a fully-numpress file is not silently
        # dropped.
        "n_unsupported": n_unsupported,
        "n_topn": n_topn,
        "titles_fallback": titles_fallback,
    }


def _identifiers(lib, handle, n: int) -> Optional[np.ndarray]:
    """The titles of the result behind ``handle`` as the U array that
    ``np.array`` of their decoded strings gives (its width the longest
    title's code points, at least 1), made natively with no Python per
    title; None where a title is not well-formed UTF-8."""
    if n == 0:
        return np.empty(0, dtype="U1")
    width = int(lib.fc_result_title_width(handle))
    if width < 0:
        return None
    width = max(width, 1)
    block = np.empty(n * width, np.uint32)
    rc = lib.fc_result_titles_u32(
        handle, block.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(width))
    if rc != 0:
        raise RuntimeError("fc_result_titles_u32 failed")
    return block.view(f"U{width}")


def _u32_col(col) -> Optional[Tuple[np.ndarray, int]]:
    """Numpy U-dtype column -> (contiguous array, width in UTF-32 code
    units) for zero-copy native access, or None if ``col`` is anything
    else (caller uses the per-object path).  Big-endian arrays (foreign
    npy files) are excluded — the native side reads native-endian."""
    if (not isinstance(col, np.ndarray) or col.dtype.kind != "U"
            or col.dtype.str[0] == ">"):
        return None
    arr = np.ascontiguousarray(col)
    return arr, arr.dtype.itemsize // 4


def _export_threads() -> int:
    """Worker threads for the export kernels (natsort + CSV format).
    Defaults to the host's core count (the 25M-export tail is the one
    single-threaded stretch left on a multicore TPU-VM host); capped at
    16 — the kernels saturate memory bandwidth well before that.
    FALCON_TPU_EXPORT_THREADS overrides."""
    try:
        t = int(os.environ.get("FALCON_TPU_EXPORT_THREADS",
                               os.cpu_count() or 1))
    except ValueError:
        t = 1
    return max(1, min(t, 16))


def _visit_array(visits):
    """ctypes array of ``ExportVisit`` rows from their field dicts."""
    array = (ExportVisit * max(len(visits), 1))()
    for slot, fields in zip(array, visits):
        for name, value in fields.items():
            setattr(slot, name, value)
    return array


def _id_fields(ids, keep: list) -> Optional[dict]:
    """The ``ExportVisit`` fields of one visit's id column, or None if it
    is not a numpy U column; arrays the fields point into go on ``keep``."""
    col = _u32_col(ids)
    if col is None or col[1] == 0:
        return None
    arr, width = col
    keep.append(arr)
    return {"n": len(arr), "id": arr.ctypes.data, "id_width": width}


def natsort_rows(id_columns) -> Optional[np.ndarray]:
    """Stable natural-order argsort of the rows of ``id_columns`` (numpy U
    columns, rows numbered column after column): the order of
    ``utils.natsort.natsort_key`` with ties in row order (parity enforced
    by tests/test_torch_natsort.py), from keys encoded once a row and
    sorted on ``_export_threads()`` threads.  Returns None when the native
    library is unavailable or a column is not a U column."""
    lib = get_lib()
    if lib is None:
        return None
    keep: list = []
    visits = [_id_fields(ids, keep) for ids in id_columns]
    if any(v is None for v in visits):
        return None
    order = np.empty(sum(v["n"] for v in visits), np.int64)
    rc = lib.fc_natsort_visits(
        _visit_array(visits), ctypes.c_int64(len(visits)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(_export_threads()))
    if rc != 0:
        raise RuntimeError("fc_natsort_visits failed")
    return order


def export_rows(fd: int, order: np.ndarray, visits, null_charge: int,
                chunk_rows: int) -> Optional[int]:
    """Write the rows of ``visits`` in ``order`` to the file descriptor
    ``fd`` as cluster-assignment CSV rows, byte-for-byte like
    ``csv.writer(f, lineterminator="\\n")`` fed ``str()`` of the same
    values (Python float-repr semantics, QUOTE_MINIMAL quoting, the empty
    null-charge field; parity enforced by tests/test_torch_export.py),
    formatted ``chunk_rows`` rows at a time on ``_export_threads()``
    threads.

    ``visits``: per visit, (filename, identifiers, charges, m/z, retention
    times, clusters), the filename a ``str`` naming every row or a U
    column; ``order`` numbers the rows visit after visit.  Returns the
    bytes written, or None (nothing written) when the native library is
    unavailable or a column has a type the formatter does not render as
    ``csv.writer`` would (the caller falls back to it)."""
    lib = get_lib()
    if lib is None:
        return None
    keep: list = []
    fields = []
    for filename, ids, charges, mzs, rts, clusters in visits:
        visit = _id_fields(ids, keep)
        const = isinstance(filename, str)
        fn = _u32_col(np.array([filename]) if const else filename)
        if visit is None or fn is None or fn[1] == 0:
            return None
        fn_arr, fn_width = fn
        if len(fn_arr) != (1 if const else visit["n"]):
            raise ValueError("export columns differ in length")
        visit.update(filename=fn_arr.ctypes.data, filename_width=fn_width,
                     filename_const=int(const))
        columns = [fn_arr, np.ascontiguousarray(charges, np.int64),
                   np.ascontiguousarray(clusters, np.int64)]
        for key, col in (("mz", mzs), ("rt", rts)):
            # str(np.float32) formats differently from str(float) and the
            # native side mirrors both; any other dtype would diverge
            # from the csv.writer fallback if widened.
            col = np.asarray(col)
            if col.dtype not in (np.float32, np.float64):
                return None
            col = np.ascontiguousarray(col)
            columns.append(col)
            visit[key] = col.ctypes.data
            visit[f"{key}_f32"] = int(col.dtype == np.float32)
        if any(len(col) != visit["n"] for col in columns[1:]):
            raise ValueError("export columns differ in length")
        visit.update(charge=columns[1].ctypes.data,
                     cluster=columns[2].ctypes.data)
        keep.extend(columns)
        fields.append(visit)
    order = np.ascontiguousarray(order, np.int64)
    err = ctypes.c_int(0)
    written = lib.fc_export_rows(
        ctypes.c_int(fd), _visit_array(fields), ctypes.c_int64(len(fields)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(order)), ctypes.c_int64(null_charge),
        ctypes.c_int64(chunk_rows), ctypes.c_int(_export_threads()),
        ctypes.byref(err))
    if written == -2:
        raise OSError(err.value, os.strerror(err.value))
    if written < 0:
        raise RuntimeError("fc_export_rows failed")
    return int(written)


def connected_components(
    u: np.ndarray, v: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, int]:
    """Connected components over an undirected edge list.

    Returns (labels, n_components); labels numbered by first occurrence.
    """
    u = np.ascontiguousarray(u, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    lib = get_lib()
    if lib is None:
        import scipy.sparse as ss
        import scipy.sparse.csgraph as csgraph

        graph = ss.coo_matrix(
            (np.ones(len(u), np.int8), (u, v)), shape=(n_nodes, n_nodes)
        )
        k, raw = csgraph.connected_components(graph, directed=False)
        # Renumber by first occurrence for determinism.
        _, first = np.unique(raw, return_index=True)
        remap = np.empty(k, np.int32)
        remap[raw[np.sort(first)]] = np.arange(k, dtype=np.int32)
        return remap[raw], k
    labels = np.empty(n_nodes, np.int32)
    k = lib.fc_connected_components(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(u)), ctypes.c_int64(n_nodes),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if k < 0:
        raise ValueError(
            "connected_components got an edge endpoint outside "
            f"[0, {n_nodes})")
    return labels, int(k)
