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
"""

import csv
import logging
import os
from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from . import native as native_lib
from .store.store import NULL_CHARGE, ChargeDataset
from .utils.natsort import natsort_key

logger = logging.getLogger("falcon_tpu")

CSV_COLUMNS = ("filename", "spectrum_id", "precursor_charge",
               "precursor_mz", "retention_time", "cluster")

# Rows per native-formatter call: bounds the transient CSV text to
# ~100-200 MB per chunk regardless of tie-group size.
_CSV_CHUNK_ROWS = 1 << 21


def _natsort_order(strings: Sequence[str]) -> np.ndarray:
    n = len(strings)
    # Numpy U arrays ride the zero-copy native path; lists go through
    # the per-object packing.
    if isinstance(strings, np.ndarray):
        secondary = np.zeros(n, dtype="U1")
    else:
        strings = list(strings)
        secondary = [""] * n
    order = native_lib.natsort_pairs(strings, secondary)
    if order is None:
        order = sorted(range(n), key=lambda i: natsort_key(strings[i]))
    return np.asarray(order, np.int64)


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

    # Pass 1 (cheap): discover which (charge, shard) spans hold which
    # input files.  Ingest writes one shard namespace per input file, so
    # shards are single-file in CLI runs; multi-file shards (unprefixed
    # writers) are handled by per-row masking below.
    file_map: dict = {}
    for ci, (ds, _labels) in enumerate(charge_entries):
        base = 0
        for shard in ds.shards:
            fns = np.load(os.path.join(shard, "filename.npy"),
                          allow_pickle=False)
            n = len(fns)
            for fn in np.unique(fns):
                file_map.setdefault(str(fn), []).append(
                    (ci, base, base + n, shard)
                )
            base += n

    names = list(file_map)
    order = _natsort_order(names)
    keys = [natsort_key(s) for s in names]
    # Merge filenames whose natural-sort keys tie (their rows interleave
    # by spectrum id, like the reference's row-wise tuple sort).
    groups: List[List[int]] = []
    for idx in order:
        if groups and keys[groups[-1][0]] == keys[idx]:
            groups[-1].append(idx)
        else:
            groups.append([idx])

    n_rows = 0
    # Explicit UTF-8 keeps the text-mode header/fallback rows and the
    # native formatter's UTF-8 buffers consistent regardless of locale;
    # newline="" keeps the csv.writer fallback byte-identical to the
    # native raw-buffer rows on platforms with newline translation.
    with open(out_path, "a", encoding="utf-8", newline="") as f_out:
        write_header(f_out)
        writer = csv.writer(f_out, lineterminator="\n")
        writer.writerow(CSV_COLUMNS)
        for group in groups:
            group_names = {names[i] for i in group}
            # Visit spans in (charge, row) order — the stable tie-break
            # order of the previous all-in-RAM sort.
            visits = sorted(
                {(ci, lo, hi, shard) for i in group
                 for (ci, lo, hi, shard) in file_map[names[i]]}
            )
            cols = {c: [] for c in ("filename", "spectrum_id",
                                    "precursor_charge", "precursor_mz",
                                    "retention_time", "cluster")}
            for ci, lo, hi, shard in visits:
                ds, labels = charge_entries[ci]

                def load(col):
                    return np.load(os.path.join(shard, f"{col}.npy"),
                                   allow_pickle=False)

                fns = load("filename")
                if len(np.unique(fns)) == 1:
                    mask = slice(None)
                else:
                    mask = np.isin(fns, list(group_names))
                cols["filename"].append(fns[mask])
                cols["spectrum_id"].append(load("identifier")[mask])
                cols["precursor_charge"].append(
                    load("precursor_charge")[mask])
                cols["precursor_mz"].append(load("precursor_mz")[mask])
                cols["retention_time"].append(
                    load("retention_time")[mask])
                cols["cluster"].append(labels[lo:hi][mask])
            merged = {k: np.concatenate(v) for k, v in cols.items()}
            sub = _natsort_order(merged["spectrum_id"])
            # Native formatter (measured 6.7x csv.writer; byte-for-byte
            # parity enforced by tests).  Rows go through in bounded
            # chunks so the transient CSV text (native string + Python
            # bytes) stays O(chunk) even when one tie-group spans the
            # whole corpus (a single-input-file run).
            for start in range(0, len(sub), _CSV_CHUNK_ROWS):
                piece = sub[start:start + _CSV_CHUNK_ROWS]
                charge_col = merged["precursor_charge"][piece]
                buf = native_lib.csv_rows(
                    merged["filename"][piece],
                    merged["spectrum_id"][piece],
                    charge_col, int(NULL_CHARGE),
                    merged["precursor_mz"][piece],
                    merged["retention_time"][piece],
                    merged["cluster"][piece],
                )
                if buf is not None:
                    f_out.flush()
                    f_out.buffer.write(buf)
                else:
                    charge_str = np.where(
                        charge_col == NULL_CHARGE, "",
                        charge_col.astype(np.int64).astype(str),
                    )
                    writer.writerows(zip(
                        merged["filename"][piece],
                        merged["spectrum_id"][piece],
                        charge_str,
                        merged["precursor_mz"][piece],
                        merged["retention_time"][piece],
                        merged["cluster"][piece],
                    ))
            n_rows += len(sub)
    return n_rows
