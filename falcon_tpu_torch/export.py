"""Streaming per-file CSV export.

The reference materializes every spectrum's metadata in one DataFrame,
natural-sorts it, and writes a single CSV (``falcon/falcon.py:206-238``)
— all-in-RAM, which at the 25M north-star scale cost this framework
26-30 GB peak RSS in round 2.  This module streams instead: the final
row order is files in natural order with each file's rows
natural-sorted by spectrum id, so the export visits one *input file's*
rows at a time (recovered shard-by-shard from the columnar store, where
ingest wrote each input file into its own shard namespace) and never
holds more than one file's columns in memory.  Peak export RSS is
O(largest input file), not O(corpus).

Ordering is identical to the previous all-in-RAM path, including the
tied-natural-sort-key interleave (SURVEY.md §3.5): filenames whose
natural-sort keys tie form one group whose rows are natural-sorted by
spectrum id with original (charge-major, store row order) order as the
stable tie-break.

Python keeps only that plan.  A shard's filename column is mapped once
(``_load``) and tested for constancy, so a one-file shard contributes its
one name and no column; only a shard of several files is masked per
group.  Each tie group's rows are then sorted (``native.natsort_rows``:
natural-order keys encoded once a row) and formatted and written
(``native.export_rows``) by native calls that read the shards' columns in
place.
"""

import csv
import ctypes
import functools
import logging
import mmap
import os
import weakref
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np

from . import native as native_lib
from .store.store import NULL_CHARGE, ChargeDataset
from .utils.natsort import natsort_key
from .utils.profiling import profiler

logger = logging.getLogger("falcon_tpu")

CSV_COLUMNS = ("filename", "spectrum_id", "precursor_charge",
               "precursor_mz", "retention_time", "cluster")

# Rows formatted at a time: bounds the transient CSV text to ~100-200 MB
# per chunk regardless of tie-group size.
_CSV_CHUNK_ROWS = 1 << 21


def _natsort_order(columns: Sequence[np.ndarray]) -> np.ndarray:
    """Stable natural-order argsort of the rows of ``columns``, numbered
    column after column: natively on keys encoded once a row, else (no
    library, or a column that is not a numpy U column) by ``natsort_key``."""
    order = native_lib.natsort_rows(columns)
    if order is None:
        strings = [s for col in columns for s in col]
        order = np.asarray(sorted(range(len(strings)),
                                  key=lambda i: natsort_key(strings[i])),
                           np.int64)
    return order


@functools.lru_cache(maxsize=None)
def _libc() -> ctypes.CDLL:
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int64]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    return libc


def _map(fd: int, size: int) -> ctypes.Array:
    """The first ``size`` bytes of ``fd`` mapped read-only, unmapped once
    nothing refers to the buffer.  The map keeps no descriptor, where
    Python's ``mmap`` keeps a duplicate one a map: a tie group holds every
    visit's columns at once, and thousands of shards would run out."""
    libc = _libc()
    ptr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
    if ptr is None or ptr == ctypes.c_void_p(-1).value:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    buf = (ctypes.c_char * size).from_address(ptr)
    weakref.finalize(buf, libc.munmap, ptr, size)
    return buf


def _load(shard: str, col: str) -> np.ndarray:
    """A shard's column, mapped read-only (``_map``): the native calls read
    it in place, and on some hosts reading a file costs twice its map;
    ``np.load`` for a file it does not map."""
    path = os.path.join(shard, f"{col}.npy")
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version in ((1, 0), (2, 0)):
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran_order, dtype = read_header(f)
            size = os.fstat(f.fileno()).st_size
            if (len(shape) == 1 and shape[0] and not fortran_order
                    and not dtype.hasobject
                    and size >= f.tell() + shape[0] * dtype.itemsize):
                col_data = np.frombuffer(_map(f.fileno(), size), dtype,
                                         shape[0], f.tell())
                col_data.flags.writeable = False
                return col_data
    return np.load(path, allow_pickle=False)


def _discover_files(charge_entries) -> Tuple[Dict[str, list],
                                             Dict[str, str], int]:
    """Which (charge, shard) spans hold which input files: file name ->
    its (charge index, lo, hi, shard) spans; shard -> the one file name
    of each shard whose filename column is constant; and the count of
    shards that name several files.  Ingest writes one shard namespace
    per input file, so a CLI run's shards each name one file; a shard of
    an unprefixed writer may name several, and its rows are masked per
    tie group."""
    file_map: Dict[str, list] = {}
    single: Dict[str, str] = {}
    n_masked = 0
    for ci, (ds, _labels) in enumerate(charge_entries):
        base = 0
        for shard in ds.shards:
            fns = _load(shard, "filename")
            n = len(fns)
            if n and (fns == fns[0]).all():
                names = [single.setdefault(shard, str(fns[0]))]
            else:
                names = [str(fn) for fn in np.unique(fns)]
                n_masked += n > 0
            for fn in names:
                file_map.setdefault(fn, []).append(
                    (ci, base, base + n, shard))
            base += n
    return file_map, single, n_masked


def _load_visit(labels: np.ndarray, shard: str, single: Dict[str, str],
                group_names: List[str]) -> tuple:
    """One visit's (filename, identifiers, charges, m/z, retention times,
    clusters): the shard's rows of the group's files, the filename the
    shard's one name or, for a shard of several files, a column."""
    cols = [_load(shard, c) for c in ("identifier", "precursor_charge",
                                      "precursor_mz", "retention_time")]
    if shard in single:
        return (single[shard], *cols, labels)
    fns = _load(shard, "filename")
    mask = np.isin(fns, group_names)
    return (fns[mask], *(c[mask] for c in cols), labels[mask])


def _write_group_fallback(writer, order: np.ndarray, visits) -> None:
    """The group's rows in ``order`` through ``csv.writer``, for a run
    without the native library or with columns it declines."""
    merged = [np.concatenate([
        np.full(len(v[1]), v[0]) if isinstance(v[0], str) else v[0]
        for v in visits])]
    merged += [np.concatenate([v[k] for v in visits]) for k in range(1, 6)]
    for start in range(0, len(order), _CSV_CHUNK_ROWS):
        piece = order[start:start + _CSV_CHUNK_ROWS]
        fns, ids, charges, mzs, rts, clusters = (c[piece] for c in merged)
        charge_str = np.where(charges == NULL_CHARGE, "",
                              charges.astype(np.int64).astype(str))
        writer.writerows(zip(fns, ids, charge_str, mzs, rts, clusters))


def export_cluster_csv(
    out_path: str,
    write_header: Callable,
    charge_entries: Iterable[Tuple[ChargeDataset, np.ndarray]],
) -> int:
    """Append the manifest header + cluster rows to ``out_path``.

    ``charge_entries``: (dataset, globally-offset labels aligned with the
    dataset's row order) per charge, in charge order.  Returns the row
    count written.
    """
    charge_entries = list(charge_entries)
    with profiler.phase("export: load"):
        file_map, single, n_masked = _discover_files(charge_entries)
    profiler.count("export.masked_shards", n_masked)

    names = list(file_map)
    order = _natsort_order([np.asarray(names)])
    keys = [natsort_key(s) for s in names]
    # Merge filenames whose natural-sort keys tie (their rows interleave
    # by spectrum id, like the reference's row-wise tuple sort).
    groups: List[List[int]] = []
    for idx in order:
        if groups and keys[groups[-1][0]] == keys[idx]:
            groups[-1].append(idx)
        else:
            groups.append([idx])
    profiler.count("export.groups", len(groups))

    n_rows = 0
    # Explicit UTF-8 keeps the text-mode header/fallback rows and the
    # native rows' UTF-8 consistent regardless of locale; newline="" keeps
    # the csv.writer fallback byte-identical to the native rows on
    # platforms with newline translation.
    with open(out_path, "a", encoding="utf-8", newline="") as f_out:
        write_header(f_out)
        writer = csv.writer(f_out, lineterminator="\n")
        writer.writerow(CSV_COLUMNS)
        for group in groups:
            group_names = [names[i] for i in group]
            # Visit spans in (charge, row) order — the stable tie-break
            # order of the previous all-in-RAM sort.
            spans = sorted({span for name in group_names
                            for span in file_map[name]})
            with profiler.phase("export: load"):
                visits = [
                    _load_visit(charge_entries[ci][1][lo:hi], shard, single,
                                group_names)
                    for ci, lo, hi, shard in spans]
            ids = [v[1] for v in visits]
            with profiler.phase("export: sort"):
                sub = _natsort_order(ids)
            # The native rows go straight to the file, in bounded chunks
            # so the transient CSV text stays O(chunk) even when one
            # tie-group spans the whole corpus (a single-input-file run).
            with profiler.phase("export: format"):
                f_out.flush()
                if native_lib.export_rows(f_out.fileno(), sub, visits,
                                          int(NULL_CHARGE),
                                          _CSV_CHUNK_ROWS) is None:
                    _write_group_fallback(writer, sub, visits)
            n_rows += len(sub)
    profiler.count("export.rows", n_rows)
    return n_rows
