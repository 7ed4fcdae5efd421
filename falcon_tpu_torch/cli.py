"""Pipeline driver / CLI entry point of the PyTorch/CUDA port.

Port of ``falcon_tpu/cli.py`` with the same parser (``config.py``, a copy
of the JAX package's), logging, work-dir lifecycle, overwrite gate,
ingest resume, per-charge clustering with globally disjoint labels, CSV and
representative-MGF export (medoids, or consensus spectra built by
``ops/consensus.py``) and run manifest, so that its CSV equals the JAX
package's byte for byte apart from the ``# work_dir`` line, and its MGF
byte for byte.  Clustering runs on the device named by
``FALCON_TPU_TORCH_DEVICE`` (default ``cuda``): the exact backend's engine
(``cluster/engine.py``), or with ``--backend ann`` the ann engine
(``cluster/ann_engine.py``; ``--ann_index auto``, ``brute`` or ``exact``,
``--rerank exact`` or ``off``, ``--cluster_method linkage`` or
``dbscan``), whose charges run two at a time when each fits one device
block, as in the JAX package.

Not ported yet, and refused with exit code 1: ``--ann_index ivf``.
"""

import logging
import os
import shutil
import sys
import tempfile
from typing import List, Union

import numpy as np

from . import __version__, seed
from .config import config
from .device import resolve_device
from .store.store import SpectrumStore
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
    if config.backend == "ann" and config.ann_index == "ivf":
        return ("--backend ann with --ann_index ivf is not yet ported to "
                "falcon_tpu_torch; use --ann_index auto, brute or exact, or "
                "the JAX package (python -m falcon_tpu)")
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

    from .preprocess import get_dim

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

    # Ingest-resume point.  The store's format is the JAX package's, so a
    # work_dir ingested by either package resumes under the other.
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
        from . import ingest

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
    from .cluster.ann_engine import device_block_cap

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

    # The ann backend clusters two charges at once when each fits one
    # device block (the JAX package's rule): one charge's host linkage
    # overlaps the other's device work.  Labels and representatives are
    # still taken in charge order below.
    overlap = (
        config.backend == "ann"
        and len(datasets) > 1
        and all(d.count_rows() <= device_block_cap() for _, d in datasets)
    )
    futures = {}
    charge_pool = None
    if overlap:
        from concurrent.futures import ThreadPoolExecutor

        charge_pool = ThreadPoolExecutor(max_workers=2)
        for charge, dataset in datasets:
            futures[charge] = charge_pool.submit(
                _generate_for_charge, dataset, mz_min, mz_max, device)

    try:
        for charge, dataset in datasets:
            with profiler.phase(f"cluster charge {charge}"):
                if charge in futures:
                    clusters, medoids = futures[charge].result()
                elif config.backend == "ann":
                    clusters, medoids = _generate_for_charge(
                        dataset, mz_min, mz_max, device)
                else:
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
            if (config.export_representatives
                    and config.representative_method == "consensus"):
                meta = dataset.read_metadata(
                    columns=("precursor_mz", "retention_time"))
                representatives.extend(_consensus_representatives(
                    dataset, meta, clusters, charge, current_label, mz_min,
                    device))
                del meta
            # Globally disjoint labels across charges.
            clusters = clusters + current_label
            current_label = int(np.amax(clusters)) + 1
            total_rows += len(clusters)
            total_clusters += len(np.unique(clusters))
            labels_by_charge.append((dataset, clusters.astype(np.int64)))
            if (config.export_representatives
                    and config.representative_method == "medoid"):
                representatives.extend(dataset.take(medoids))
    finally:
        if charge_pool is not None:
            charge_pool.shutdown(wait=True, cancel_futures=True)

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

    from .export import export_cluster_csv

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
                from .ms_io import mgf_io

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


def _generate_for_charge(dataset, mz_min: float, mz_max: float, device):
    """The ann engine on one charge bucket with the parsed options."""
    from .cluster import ann_engine

    return ann_engine.generate_clusters(
        dataset,
        eps=config.eps,
        min_samples=config.min_samples,
        min_matches=config.min_matched_peaks,
        precursor_tol_mass=config.precursor_tol[0],
        precursor_tol_mode=config.precursor_tol[1],
        rt_tol=config.rt_tol,
        fragment_tol=config.fragment_tol,
        batch_size=config.batch_size,
        low_dim=config.low_dim,
        n_neighbors=config.n_neighbors,
        n_neighbors_ann=config.n_neighbors_ann,
        hash_seed=config.hash_seed,
        min_mz=mz_min,
        max_mz=mz_max,
        max_peaks=config.max_peaks_used,
        devices=config.devices,
        ann_index=config.ann_index,
        rerank=config.rerank,
        cluster_method=config.cluster_method,
        linkage=config.linkage,
        device=device,
    )


def _consensus_representatives(
    dataset, meta, labels: np.ndarray, charge, label_offset: int,
    mz_min: float, device=None,
) -> List[dict]:
    """Consensus representative rows for one charge bucket.

    Builds one merged spectrum per cluster on ``device``
    (``ops/consensus.py``); cluster metadata (precursor m/z, retention
    time) is the member mean, and the identifier records the global
    cluster label.  A copy of the JAX package's function.
    """
    from .ops.consensus import consensus_spectra

    offsets, mz_flat, int_flat = dataset.read_peaks()
    cons = consensus_spectra(
        offsets, mz_flat, int_flat, labels,
        config.fragment_tol, mz_min,
        min_fraction=config.consensus_min_fraction,
        max_peaks=config.max_peaks_used,
        device=device,
    )
    pmz = np.asarray(meta["precursor_mz"], np.float64)
    rt = np.asarray(meta["retention_time"], np.float64)
    # Per-cluster member means in one pass over the labels.
    clustered = labels >= 0
    member_labels = labels[clustered]
    counts = np.bincount(member_labels).astype(np.float64)
    pmz_mean = np.bincount(member_labels, weights=pmz[clustered]) / counts
    rt_mean = np.bincount(member_labels, weights=rt[clustered]) / counts
    rows = []
    for label in sorted(cons):
        mz, intensity = cons[label]
        rows.append(
            {
                "identifier": f"consensus_cluster{label_offset + label}",
                "precursor_mz": float(pmz_mean[label]),
                "precursor_charge": charge,
                "retention_time": float(rt_mean[label]),
                "mz": mz,
                "intensity": intensity,
                "filename": "",
            }
        )
    return rows


def _rep_spectra(representatives: List[dict]) -> List:
    """Representative rows (medoid ``dataset.take`` rows or consensus
    rows) as :class:`Spectrum` objects, shared by the MGF export and the
    library API."""
    from .ms_io.containers import Spectrum

    return [
        Spectrum(
            r["identifier"], r["precursor_mz"],
            r["precursor_charge"], r["mz"], r["intensity"],
            r["retention_time"], r["filename"],
        )
        for r in representatives
    ]


def _write_manifest(f_out) -> None:
    """'#'-prefixed run-manifest header (reference ``_write_cluster_info``,
    ``falcon/falcon.py:483-524``; same keys, same order, same
    formatting).  The cluster rows themselves stream after the header
    (``falcon_tpu/export.py``)."""
    f_out.write(f"# falcon-tpu version {__version__}\n")
    f_out.write(f"# work_dir = {config.work_dir}\n")
    f_out.write(f"# overwrite = {config.overwrite}\n")
    f_out.write(
        f"# export_representatives = {config.export_representatives}\n"
    )
    f_out.write(
        f"# precursor_tol = {config.precursor_tol[0]:.2f} "
        f"{config.precursor_tol[1]}\n"
    )
    f_out.write(f"# rt_tol = {config.rt_tol}\n")
    f_out.write(f"# fragment_tol = {config.fragment_tol:.2f}\n")
    f_out.write(f"# linkage = {config.linkage}\n")
    f_out.write(
        f"# distance_threshold = {config.distance_threshold:.3f}\n"
    )
    f_out.write(f"# min_matched_peaks = {config.min_matched_peaks}\n")
    f_out.write(f"# batch_size = {config.batch_size}\n")
    f_out.write(f"# min_peaks = {config.min_peaks}\n")
    f_out.write(f"# min_mz_range = {config.min_mz_range:.2f}\n")
    f_out.write(f"# min_mz = {config.min_mz:.2f}\n")
    f_out.write(f"# max_mz = {config.max_mz:.2f}\n")
    f_out.write(
        f"# remove_precursor_tol = {config.remove_precursor_tol:.2f}\n"
    )
    f_out.write(f"# min_intensity = {config.min_intensity:.2f}\n")
    f_out.write(f"# max_peaks_used = {config.max_peaks_used}\n")
    f_out.write(f"# scaling = {config.scaling}\n")
    # falcon-tpu additions (after the reference's 17 keys).  The
    # manifest is a COMPLETE run record (like the reference's,
    # falcon/falcon.py:492-522): every option that can change the
    # output appears, so a run is reproducible from its CSV alone.
    f_out.write(f"# backend = {config.backend}\n")
    if config.export_representatives:
        f_out.write(
            f"# representative_method = "
            f"{config.representative_method}\n"
        )
        if config.representative_method == "consensus":
            f_out.write(
                f"# consensus_min_fraction = "
                f"{config.consensus_min_fraction}\n"
            )
    if config.backend == "ann":
        f_out.write(f"# cluster_method = {config.cluster_method}\n")
        f_out.write(f"# eps = {config.eps}\n")
        f_out.write(f"# low_dim = {config.low_dim}\n")
        f_out.write(f"# n_neighbors = {config.n_neighbors}\n")
        f_out.write(f"# n_neighbors_ann = {config.n_neighbors_ann}\n")
        f_out.write(f"# n_probe = {config.n_probe}\n")
        f_out.write(f"# min_samples = {config.min_samples}\n")
        f_out.write(f"# ann_index = {config.ann_index}\n")
        f_out.write(f"# hash_seed = {config.hash_seed}\n")
        f_out.write(f"# rerank = {config.rerank}\n")
    f_out.write(f"# devices = {config.devices}\n")
    f_out.write("#\n")
