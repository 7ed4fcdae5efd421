"""Peak-file ingest: parallel parsing + preprocessing into the store.

Mirrors the reference's ingest/partition subsystem
(``falcon/falcon.py:247-480``): peak files are parsed and preprocessed by
a pool of worker processes (one task per file, pool size
min(#files, #cpus), reference ``falcon.py:267``), and the processed
spectra are appended in 10k batches to per-charge datasets.

This module deliberately imports no JAX so ingest worker processes never
touch the TPU plugin (the chip is exclusive to the parent process).
"""

import glob
import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .ms_io import ms_io
from .preprocess import spectrum as prep
from .store.store import SpectrumStore
from .utils.profiling import profiler

logger = logging.getLogger("falcon_tpu")

FileResult = Tuple[Union[List[dict], Dict[str, np.ndarray]], int]


def read_and_process_file(
    filename: str, process_kwargs: Dict, allow_native: bool = True
) -> FileResult:
    """Parse one peak file and preprocess its spectra.

    Returns (result, low-quality count) where result is either a columnar
    batch dict (the native C++ fast path — parse + the full preprocessing
    chain for all four formats: MGF and MSP in
    ``native/falcon_ingest.cc``, mzML/mzXML in ``native/falcon_mzml.cc``)
    or a list of processed
    spectrum dicts (the pure-Python fallback when the native library is
    unavailable or returns nothing for a non-empty file).  Mirrors
    reference ``_read_spectra`` (``falcon/falcon.py:362-392``), including
    storing the absolute filename on each spectrum.  A gzipped input is
    decompressed to a temp file once so the native fast path applies;
    the ORIGINAL ``.gz`` path is what lands in the filename metadata.
    """
    filename = os.path.abspath(filename)
    tmp = ms_io.decompress_to_temp(filename)
    try:
        return _read_processed(tmp or filename, filename, process_kwargs,
                               allow_native)
    finally:
        if tmp is not None:
            os.remove(tmp)


def _read_processed(
    parse_path: str, record_filename: str, process_kwargs: Dict,
    allow_native: bool = True, by_charge: bool = False,
) -> FileResult:
    """Core of :func:`read_and_process_file`: parse ``parse_path`` (an
    on-disk, already-decompressed peak file) while recording
    ``record_filename`` as each spectrum's origin.  ``by_charge`` groups
    a native batch's rows by charge, for ``store.RunPlan``."""
    filename = record_filename
    lower = parse_path.lower()
    native_fmt = next((fmt for fmt in (".mgf", ".mzml", ".mzxml", ".msp")
                       if lower.endswith(fmt)), None)
    if allow_native and native_fmt:
        from . import native

        ingest_fn = {".mgf": native.mgf_ingest,
                     ".mzml": native.mzml_ingest,
                     ".mzxml": native.mzxml_ingest,
                     ".msp": native.msp_ingest}[native_fmt]
        batch = ingest_fn(parse_path, by_charge=by_charge, **process_kwargs)
        if (
            batch is not None
            and batch.get("n_read", 1) == 0
            and batch.get("n_blocks", 0) == 0
            and not batch.get("truncated")
            and os.path.getsize(parse_path) > 0
        ):
            # The native scanner found no spectrum ELEMENTS in a
            # non-empty file (e.g. unusual whitespace/namespacing in the
            # XML): fall back to the Python reader instead of silently
            # dropping the file's spectra.  n_blocks > 0 with n_read == 0
            # means the scanner DID see the elements and the file
            # legitimately has no usable spectra (e.g. MS1-only) — no
            # fallback re-parse then.
            logger.warning(
                "Native parser found no spectra in non-empty file %s; "
                "falling back to the Python reader", filename,
            )
            batch = None
        if batch is not None:
            _count_ranges([batch])
            if batch.get("truncated"):
                logger.warning(
                    "Failed to read file %s: truncated document "
                    "(parsed %d complete spectra)",
                    filename, batch["n_read"],
                )
            if batch.get("n_unsupported", 0) > 0:
                # Mirrors the Python readers' once-per-file warning so a
                # fully numpress-compressed file is never silently empty.
                logger.warning(
                    "Skipped %d spectra with unsupported binary "
                    "compression (e.g. MS-Numpress) in %s",
                    batch["n_unsupported"], filename,
                )
            n = len(batch["precursor_mz"])
            batch["filename"] = np.repeat(np.array([filename]), n)
            return batch, batch["n_low_quality"]
    low_quality_counter = 0
    spectra = []
    for spec in ms_io.get_spectra(parse_path):
        spec.filename = filename
        processed = prep.process_spectrum(spec, **process_kwargs)
        if processed is None:
            low_quality_counter += 1
        else:
            spectra.append(processed)
    return spectra, low_quality_counter


# Files below this size are not worth splitting (range-parse overhead
# plus thread startup would exceed the parse itself).
_RANGE_MIN_BYTES = 16 * 2**20
_RANGE_TARGET_BYTES = 8 * 2**20


def _ingest_ranges(
    parse_path: str, fmt: str, process_kwargs: Dict, budget: int,
    writer, filename: str,
) -> Optional[Tuple[List[str], int, int]]:
    """Parse one large peak file as ``budget`` concurrent native range
    calls and write its shards as the ranges come in.

    The native range parsers release the GIL, so a thread pool gives
    real parse parallelism without process-spawn cost; per-range batches
    concatenate to the whole-file parse exactly (ownership by BEGIN IONS
    line offset for MGF and Name: line offset for MSP —
    ``native/falcon_ingest.cc`` — and by spectrum/scan open-tag offset
    for mzML/mzXML — ``native/falcon_mzml.cc``).  Each range's rows come
    grouped by charge, and the ranges are planned into shards in file
    order as they finish (``store.RunPlan``), so the shards of the first
    ranges are written on the threads that parsed them while later ranges
    still parse.  Returns (charge keys, spectra kept, low-quality count),
    or None when the file is too small to split, the native library is
    unavailable or the ranges find no spectrum at all; nothing is written
    then, and the caller parses the file as one range.
    """
    from concurrent.futures import ThreadPoolExecutor

    from . import native

    size = os.path.getsize(parse_path)
    n_ranges = min(budget, max(size // _RANGE_TARGET_BYTES, 1))
    if n_ranges <= 1 or native.get_lib() is None:
        return None
    ingest_fn = {".mgf": native.mgf_ingest,
                 ".mzml": native.mzml_ingest,
                 ".mzxml": native.mzxml_ingest,
                 ".msp": native.msp_ingest}[fmt]
    bounds = [size * i // n_ranges for i in range(n_ranges + 1)]
    batches = []
    with ThreadPoolExecutor(max_workers=n_ranges) as pool:
        futures = [pool.submit(ingest_fn, parse_path, start=bounds[i],
                               end=bounds[i + 1], by_charge=True,
                               **process_kwargs)
                   for i in range(n_ranges)]
        plan = writer.plan_runs(filename, pool)
        with profiler.phase("ingest: parse"):
            for future in futures:
                batch = future.result()
                if batch is None:
                    raise OSError(f"Cannot open {parse_path}")
                batches.append(batch)
                plan.add(batch)
        _count_ranges(batches)
        n_read = sum(b["n_read"] for b in batches)
        # n_blocks > 0 with n_read == 0 = legitimately empty (e.g.
        # MS1-only): go on, without parsing the file again.
        if n_read == 0 and sum(b["n_blocks"] for b in batches) == 0:
            return None  # unusual layout: let the single-range path decide
        if any(b["truncated"] for b in batches):
            logger.warning(
                "Failed to read file %s: truncated document "
                "(parsed %d complete spectra)", filename, n_read,
            )
        n_unsupported = sum(b["n_unsupported"] for b in batches)
        if n_unsupported > 0:
            logger.warning(
                "Skipped %d spectra with unsupported binary compression "
                "(e.g. MS-Numpress) in %s", n_unsupported, filename,
            )
        with profiler.phase("ingest: write"):
            charges = plan.finish()
    return (charges, sum(len(b["precursor_mz"]) for b in batches),
            sum(b["n_low_quality"] for b in batches))


def _count_ranges(batches: List[dict]) -> None:
    """The recorder's counts of native range parses."""
    profiler.count("ingest.ranges", len(batches))
    profiler.count("ingest.topn_cut", sum(b["n_topn"] for b in batches))
    profiler.count("ingest.titles_fallback",
                   sum(b["titles_fallback"] for b in batches))


def ingest_file_to_store(
    filename: str,
    file_index: int,
    store_root: str,
    process_kwargs: Dict,
    range_budget: int = 1,
) -> Tuple[List[str], int, int]:
    """Worker entry: parse + preprocess one file and write shards
    directly into the store (no spectra cross the process boundary —
    shard names are namespaced by the input file index, so concurrent
    writers never collide and runs stay deterministic).

    ``range_budget`` > 1 lets a large file (any supported format)
    parse as that many concurrent byte ranges (GIL-released native calls
    on threads) when the pool has spare CPUs — the single-big-file case
    the reference's one-process-per-file layout
    (``falcon/falcon.py:267``) leaves serial.

    Returns (charge keys written, spectra kept, low-quality count).
    """
    filename = os.path.abspath(filename)
    store = SpectrumStore(store_root)
    writer = store.writer(batch_size=10_000,
                          shard_prefix=f"{file_index:04d}_")
    ranged = None
    # Gzipped inputs decompress ONCE here so both the range-parallel
    # and single-range paths parse the same temp file; the original
    # .gz path is what the store records.
    tmp = ms_io.decompress_to_temp(filename)
    parse_path = tmp or filename
    try:
        lower = parse_path.lower()
        fmt = next((f for f in (".mgf", ".mzml", ".mzxml", ".msp")
                    if lower.endswith(f)), None)
        if (range_budget > 1 and fmt is not None
                and os.path.getsize(parse_path) >= _RANGE_MIN_BYTES):
            ranged = _ingest_ranges(parse_path, fmt, process_kwargs,
                                    range_budget, writer, filename)
        if ranged is None:
            with profiler.phase("ingest: parse"):
                result, lqc = _read_processed(parse_path, filename,
                                              process_kwargs, by_charge=True)
    finally:
        if tmp is not None:
            os.remove(tmp)
    if ranged is not None:
        charges, n_kept, lqc = ranged
    else:
        with profiler.phase("ingest: write"):
            if isinstance(result, dict):
                n_kept = len(result["precursor_mz"])
                plan = writer.plan_runs(filename)
                plan.add(result)
                charges = plan.finish()
            else:
                n_kept = len(result)
                from .store.store import charge_key

                charges = sorted({charge_key(spec["precursor_charge"])
                                  for spec in result})
                writer.add_many(result)
                writer.close()
    profiler.count("ingest.spectra", n_kept)
    profiler.count("ingest.shards", writer.shards_written)
    return charges, n_kept, lqc


def prepare_spectra(
    store: SpectrumStore,
    input_patterns: List[str],
    process_kwargs: Dict,
    max_workers: Optional[int] = None,
) -> List[Optional[int]]:
    """Read all input files into per-charge datasets; returns the charges.

    Mirrors reference ``_prepare_spectra`` (``falcon/falcon.py:247-328``):
    glob expansion, process-parallel parsing, 10k-batch appends, per-charge
    partitioning (a ``None`` charge gets its own bucket), and the
    read/skip counters.  Workers write shards directly (one shard
    namespace per input file) instead of shipping spectra back through
    the process boundary.
    """
    input_filenames = [
        fn for pattern in input_patterns for fn in sorted(glob.glob(pattern))
    ]
    logger.info("Read spectra from %d peak file(s)", len(input_filenames))
    if not input_filenames:
        raise ValueError("No input peak files found")
    if max_workers is None:
        max_workers = min(len(input_filenames), multiprocessing.cpu_count())
    # CPUs left idle by one-worker-per-file go to intra-file range
    # parallelism for large MGFs (threaded GIL-released native parses).
    range_budget = max(
        1, multiprocessing.cpu_count() // max(len(input_filenames), 1)
    )

    charges = set()
    low_quality_counter, n_spectra = 0, 0

    def consume(result):
        nonlocal low_quality_counter, n_spectra
        charge_keys, n_kept, lqc = result
        low_quality_counter += lqc
        n_spectra += n_kept
        for key in charge_keys:
            charges.add(None if key == "None" else int(key))

    if max_workers <= 1 or len(input_filenames) == 1:
        for idx, filename in enumerate(input_filenames):
            consume(ingest_file_to_store(
                filename, idx, store.root, process_kwargs,
                range_budget=range_budget,
            ))
    else:
        # spawn (not fork): the parent may hold a live TPU client.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(
            max_workers=max_workers, mp_context=ctx
        ) as pool:
            futures = [
                pool.submit(ingest_file_to_store, fn, idx, store.root,
                            process_kwargs, range_budget)
                for idx, fn in enumerate(input_filenames)
            ]
            for future in as_completed(futures):
                consume(future.result())

    logger.info(
        "Read %d spectra from %d peak files", n_spectra,
        len(input_filenames),
    )
    logger.info("Skipped %d low-quality spectra", low_quality_counter)
    charge_list = sorted(
        charges, key=lambda c: (c is None, c if c is not None else 0)
    )
    store.save_charges(charge_list)
    return charge_list
