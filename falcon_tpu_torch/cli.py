"""Pipeline driver / CLI entry point of the PyTorch/CUDA port.

Port of ``falcon_tpu/cli.py`` with the same parser (the shared
``falcon_tpu.config.config``), logging, work-dir lifecycle, overwrite gate,
ingest resume, per-charge clustering with globally disjoint labels, CSV and
medoid-MGF export and run manifest, so that its CSV equals the JAX
package's byte for byte apart from the ``# work_dir`` line.  Clustering
runs the exact backend's engine (``cluster/engine.py``) on the device
named by ``FALCON_TPU_TORCH_DEVICE`` (default ``cuda``).

Not ported yet, and refused with exit code 1: ``--backend ann`` and
``--representative_method consensus``.
"""

import logging
import os
import shutil
import sys
import tempfile
from typing import List, Union

import numpy as np

from falcon_tpu import __version__, seed
# The JAX package's CLI module imports JAX only inside its run function;
# its manifest writer and representative builder are shared so that both
# packages write the same bytes.
from falcon_tpu.cli import _rep_spectra, _write_manifest
from falcon_tpu.config import config
from falcon_tpu.store.store import SpectrumStore

from .device import resolve_device
from .utils.profiling import profiler

logger = logging.getLogger("falcon_tpu")

seed.set_seeds()


def main(args: Union[str, List[str], None] = None,
         _collect: Union[dict, None] = None) -> int:
    """CLI entry point.  An auto-created temp work_dir (no --work_dir
    given) is removed on every exit path.

    ``_collect`` is the library-API hook (``falcon_tpu_torch.api``): a dict
    the pipeline fills with in-memory results (``assignments``,
    ``representatives``).  In collect mode user-input errors raise instead
    of returning an exit code, and the CSV/MGF export only runs when
    ``_collect["write_outputs"]`` is true."""
    cleanup: list = []
    try:
        return _run(args, cleanup, _collect)
    finally:
        for path in cleanup:
            shutil.rmtree(path, ignore_errors=True)


def _not_ported() -> Union[str, None]:
    """Why the parsed configuration cannot run on the port, or None."""
    if config.backend == "ann":
        return ("--backend ann is not yet ported to falcon_tpu_torch; use "
                "--backend exact, or the JAX package (python -m falcon_tpu)")
    if config.representative_method == "consensus":
        return ("--representative_method consensus is not yet ported to "
                "falcon_tpu_torch; use medoid, or the JAX package "
                "(python -m falcon_tpu)")
    return None


def _run(args: Union[str, List[str], None], cleanup: list,
         collect: Union[dict, None] = None) -> int:
    # Configure logging.  Idempotent: repeated main() calls in one process
    # must not stack handlers and duplicate every line.
    logging.captureWarnings(True)
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    if not any(getattr(h, "_falcon_tpu", False) for h in root.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler._falcon_tpu = True
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(
            logging.Formatter(
                "{asctime} {levelname} [{name}/{processName}] "
                "{module}.{funcName} : {message}",
                style="{",
            )
        )
        root.addHandler(handler)

    config.parse(args)
    logger.info("falcon-tpu version %s (PyTorch/CUDA port)",
                str(__version__))
    for key in (
        "work_dir", "overwrite", "export_representatives", "precursor_tol",
        "rt_tol", "fragment_tol", "linkage", "distance_threshold",
        "min_matched_peaks", "batch_size", "min_peaks", "min_mz_range",
        "min_mz", "max_mz", "remove_precursor_tol", "min_intensity",
        "max_peaks_used", "scaling", "backend", "cluster_method", "eps",
        "low_dim", "n_neighbors", "n_neighbors_ann", "n_probe",
        "min_samples", "ann_index", "hash_seed", "rerank",
        "representative_method",
        "consensus_min_fraction", "devices", "profile",
    ):
        logger.debug("%s = %s", key, config[key])

    reason = _not_ported()
    if reason is not None:
        logger.error(reason)
        logging.shutdown()
        if collect is not None:
            raise NotImplementedError(reason)
        return 1
    device = resolve_device()
    logger.info("Device: %s", device)

    if config.work_dir is None:
        config.work_dir = tempfile.mkdtemp()
        cleanup.append(config.work_dir)
    elif os.path.isdir(config.work_dir):
        logging.warning(
            "Working directory %s already exists, previous results might "
            "get overwritten", config.work_dir,
        )
    os.makedirs(config.work_dir, exist_ok=True)
    os.makedirs(os.path.join(config.work_dir, "spectra"), exist_ok=True)

    # Output-exists / overwrite gate.  Skipped when the library API runs
    # without file outputs: nothing would be written.
    write_outputs = collect is None or bool(collect.get("write_outputs"))
    exit_exists = False
    if write_outputs:
        for ext, desc in ((".csv", "cluster assignments"),
                          (".mgf", "cluster representatives")):
            path = f"{config.output_filename}{ext}"
            if os.path.isfile(path):
                if config.overwrite:
                    logger.warning(
                        "Output file %s (%s) already exists and will be "
                        "overwritten", path, desc,
                    )
                    os.remove(path)
                else:
                    logger.error(
                        "Output file %s (%s) already exists, aborting...",
                        path, desc,
                    )
                    exit_exists = True
    if exit_exists:
        logging.shutdown()
        if collect is not None:
            raise FileExistsError(
                f"Output file(s) for {config.output_filename!r} already "
                "exist; pass overwrite=True to replace them"
            )
        return 1

    from falcon_tpu.preprocess import get_dim

    _, mz_min, mz_max = get_dim(
        config.min_mz, config.max_mz, config.fragment_tol
    )
    process_kwargs = dict(
        min_peaks=config.min_peaks,
        min_mz_range=config.min_mz_range,
        mz_min=mz_min,
        mz_max=mz_max,
        remove_precursor_tolerance=config.remove_precursor_tol,
        min_intensity=config.min_intensity,
        max_peaks_used=config.max_peaks_used,
        scaling=None if config.scaling == "off" else config.scaling,
    )

    store = SpectrumStore(os.path.join(config.work_dir, "spectra"))
    if config.overwrite:
        store.clear()

    profiler.reset()
    if config.profile:
        profiler.start_trace(config.profile)

    # Ingest-resume point: the shared store, so a work_dir ingested by
    # either package resumes under the other.
    charges = store.load_charges()
    if charges is None:
        # The charge cache is the commit record of a completed ingest; a
        # store with content but no cache is a crashed ingest.
        if os.listdir(store.root):
            logger.warning(
                "Found a partially-written spectrum store (no charge "
                "cache) in %s; discarding it and re-ingesting",
                store.root,
            )
            store.clear()
        from falcon_tpu import ingest

        with profiler.phase("ingest"):
            try:
                charges = ingest.prepare_spectra(
                    store, config.input_filenames, process_kwargs
                )
            except ValueError as e:
                # User-input errors: report cleanly and exit 1.
                logger.error(str(e))
                logging.shutdown()
                if collect is not None:
                    raise
                return 1

    from .cluster import engine

    labels_by_charge: list = []
    current_label, representatives = 0, []
    total_rows = total_clusters = 0
    datasets = []
    for charge in charges:
        # A charge bucket whose persisted store is missing or damaged is
        # dropped with an error and the run continues.
        try:
            dataset = store.dataset(charge)
            dataset.validate()
            if dataset.count_rows() == 0:
                continue
        except (ValueError, OSError) as exc:
            logger.error("Failed to open dataset for charge %s: %s",
                         charge, exc)
            continue
        datasets.append((charge, dataset))

    for charge, dataset in datasets:
        with profiler.phase(f"cluster charge {charge}"):
            clusters, medoids = engine.generate_clusters(
                dataset,
                config.linkage,
                config.distance_threshold,
                config.min_matched_peaks,
                config.precursor_tol[0],
                config.precursor_tol[1],
                config.rt_tol,
                config.fragment_tol,
                config.batch_size,
                max_peaks=config.max_peaks_used,
                devices=config.devices,
                device=device,
            )
        # Globally disjoint labels across charges.
        clusters = clusters + current_label
        current_label = int(np.amax(clusters)) + 1
        total_rows += len(clusters)
        total_clusters += len(np.unique(clusters))
        labels_by_charge.append((dataset, clusters.astype(np.int64)))
        if config.export_representatives:
            representatives.extend(dataset.take(medoids))

    if not labels_by_charge:
        logger.error("No spectra found to cluster")
        logging.shutdown()
        if collect is not None:
            raise ValueError("No spectra found to cluster")
        return 1

    def _collect_results() -> None:
        # Library API: in-memory results, one row per clustered spectrum
        # in charge-major store order; runs after any file export.
        cols = {c: [] for c in ("filename", "identifier",
                                "precursor_charge", "precursor_mz",
                                "retention_time")}
        labs = []
        for ds, labels in labels_by_charge:
            meta = ds.read_metadata()
            for c in cols:
                cols[c].append(meta[c])
            labs.append(labels)
        assignments = {c: np.concatenate(v) for c, v in cols.items()}
        assignments["cluster"] = np.concatenate(labs)
        collect["assignments"] = assignments
        collect["representatives"] = (
            _rep_spectra(representatives)
            if config.export_representatives else []
        )

    if not write_outputs:
        _collect_results()
        profiler.stop_trace()
        profiler.log_summary()
        logging.shutdown()
        return 0

    logger.info(
        "Export cluster assignments of %d spectra to %d unique clusters "
        "to output file %s",
        total_rows, total_clusters, f"{config.output_filename}.csv",
    )
    from concurrent.futures import ThreadPoolExecutor

    from falcon_tpu.export import export_cluster_csv

    # Outputs publish atomically: written to a same-directory .partial
    # path and renamed only once every export succeeded.  Futures, not
    # bare threads, so a failed export re-raises here.
    csv_path = f"{config.output_filename}.csv"
    mgf_path = f"{config.output_filename}.mgf"
    csv_tmp, mgf_tmp = csv_path + ".partial", mgf_path + ".partial"
    for stale in (csv_tmp, mgf_tmp):
        if os.path.exists(stale):
            os.remove(stale)
    with profiler.phase("export"):
        with ThreadPoolExecutor(max_workers=2) as export_pool:
            csv_future = export_pool.submit(
                export_cluster_csv, csv_tmp, _write_manifest,
                labels_by_charge,
            )
            if config.export_representatives:
                # mgf_io directly: the extension dispatch in ms_io would
                # reject the ".partial" temp name.
                from falcon_tpu.ms_io import mgf_io

                spectra = _rep_spectra(representatives)
                logger.info(
                    "Export %d cluster representative spectra to output "
                    "file %s", len(spectra), mgf_path,
                )
                export_pool.submit(
                    mgf_io.write_spectra, mgf_tmp, spectra,
                ).result()
            csv_future.result()
            os.replace(csv_tmp, csv_path)
            if config.export_representatives:
                os.replace(mgf_tmp, mgf_path)

    if collect is not None:
        _collect_results()

    profiler.stop_trace()
    profiler.log_summary()

    logging.shutdown()
    return 0
