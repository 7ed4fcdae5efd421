"""Per-charge clustering with the ann backend, on PyTorch.

Port of ``falcon_tpu/cluster/ann_engine.py`` for ``--backend ann``, the
same labels and medoids:

1. sort the bucket by precursor m/z and split it into device blocks of at
   most ``device_block_cap()`` spectra on tolerance gaps (logging every
   forced cut); the blocks run ``block_pipeline_depth()`` at a time on one
   device (default 2, each worker thread on a CUDA stream of its own, so
   one block's host work overlaps the next one's device work), or
   round-robin over the devices of ``--devices N``, each block on one
   device; results merge in block order, so the labels are the serial
   loop's;
2. per block: pad and upload the peaks (``ops/xfer.py``) and find each
   row's neighbours in its precursor band:

   - ``--ann_index exact``: the exact top-k over the whole band
     (``ops/exact_knn.py``, kernel K2), exact peak-matching cosines;
   - ``--ann_index auto`` or ``brute`` with ``--rerank exact`` (the
     default): hash plain and tolerance-spread vectors in one pass
     (``ops/vectorize.py``), scan the band for the largest upper bounds
     ``spread_i . plain_j`` in bfloat16 (``ops/knn.py``), keep the
     candidates whose bound can reach ``1 - eps`` and score them exactly
     (``ops/rerank.py``, the pair-list kernel);
   - ``--ann_index auto`` or ``brute`` with ``--rerank off``: the exact
     top ``n_neighbors`` of the cosines of L2-normalised hashed vectors, in
     full float32; eps is thresholded on those cosines;
   - ``--ann_index ivf``: the IVF index (``ops/ivf.py``), its quantizer
     trained on the normalised spread vectors; with ``--rerank exact`` it
     ranks the upper bounds ``spread_i . plain_j`` in bfloat16 (the
     probe-scan kernel, IVF.1; see the switches below for the other
     quantizer and ranking), cuts the lists to ``k_ann``, filters them
     by RT on the host and scores the first power-of-two columns covering
     the widest band exactly; with ``--rerank off`` it ranks the cosines
     of the normalised plain vectors in float32, cut to ``n_neighbors``;

   then DBSCAN on the lists (``ops/density.py``): with ``min_samples = 1``
   under ``--cluster_method linkage`` (the eps-connected components),
   with ``min_samples`` under ``--cluster_method dbscan``;
3. ``--cluster_method linkage``: per component, as one exact-engine
   interval, condensed exact distances (K4 for components of up to
   ``LINKAGE_GROUP_MAX`` spectra; larger ones through the pruned pair
   lists under complete or single linkage, or K1), then the native
   linkage, the cut at eps, the precursor / RT refinement and the medoids;
   ``--cluster_method dbscan``: the precursor / RT refinement of the
   DBSCAN clusters (``_refine_and_medoids``), and medoids from the sparse
   exact lists or, under ``--rerank off``, from the hashed vectors
   (``ops/medoids.py``).

**One wide scan instead of the JAX package's retrieval passes.** The JAX
package scans for ``k_ann`` candidates per row with ``approx_max_k`` and a
count that certifies every candidate at or above the compaction threshold
was retrieved; when that fails it scans with exact top-k, in
boundary-continued passes of ``k_ann`` each when the bands outgrow one
pass (``widen_passes``), reranks each pass's survivors and merges them
into the running top ``k_final``.  The port scans once with exact top-k at
the JAX package's total coverage, ``k_ann * widen_passes`` (at most
``n - 1``), and reranks once.  The labels are the same:

- every survivor of the compaction has a bound at or above the threshold;
  the certified lists and the exact top-k lists both hold all of them
  whenever they fit, at the same positions (the lists agree on their
  first ``k_ann`` entries, and survivors precede the rest of the sorted
  list apart from RT holes, which both lists punch at the same places);
- a stable top-k over [running top-k_final, next pass] equals one stable
  top-k over the whole concatenation, so the merged passes equal one wide
  rerank;
- the JAX package stops early only when no row's next pass can hold a
  survivor, which skips passes whose survivors are empty.

``tests/test_torch_ann.py`` holds this against the JAX package in both of
its modes (certified, and forced exact multi-pass).

**The JAX package's switches.**  Those that change the result are read
where and when the JAX package reads them, per block, with its defaults:
``FALCON_TPU_KNN_DTYPE=f32`` (``scan_bf16``), ``FALCON_TPU_IVF_COARSE=plain``
(``ivf_coarse_spread``), ``FALCON_TPU_IVF_RANK=cos`` (``ivf_rank_ub``),
``FALCON_TPU_LINKAGE_PRUNE=0`` (``linkage_prune``),
``FALCON_TPU_LINKAGE_GROUP_MAX`` (``linkage_group_max``),
``FALCON_TPU_MAX_NEIGHBORS`` (``max_neighbors``),
``FALCON_TPU_DEVICE_BLOCK_CAP`` and ``FALCON_TPU_BLOCK_PIPELINE``.  Its
retrieval switches (``FALCON_TPU_KNN_CERTIFIED``,
``FALCON_TPU_WIDEN_PASS_CAP``) only choose among the routes that the one
wide scan replaces, so they are not read.  ``tests/test_torch_switches.py``
and ``tests/test_torch_switches_index.py`` hold the CLI's bytes against the
JAX package's under each switch.

**``--devices N``** (``devices``, N of ``device.visible_devices``: N cards,
or N virtual shards of one): a block of the default and brute indexes
under ``--rerank exact`` runs the whole chain sharded over the mesh
(``parallel/sharded_pipeline.py``: vectorize, the halo k-NN of the top
``n_neighbors_ann`` hashed cosines, the exact rerank against a halo pool,
DBSCAN merged by ``pmin``), with the JAX package's sharded medoid scores
in dbscan mode (hashed vectors, not the exact lists); under ``--rerank
off`` only the k-NN is sharded (``parallel/sharded_knn.py``).  A band
wider than one shard's halo is logged and takes the one-device chain.
``--ann_index exact`` shards its search (``parallel/
sharded_exact_index.py``: the pair-list kernel against a halo pool, the
JAX package's two sorts) and keeps the lists on the card for the rest of
the chain; ``--ann_index ivf`` runs its self-search as a ring over the
mesh (``parallel/sharded_ivf.py``: IVF.1 on each step, the corpus slabs
rotating), then cuts and RT-filters the lists as on one device.  Each
sharded search that returns None (a band wider than the halo, or a mesh
that does not divide the IVF list count) is logged and takes the
one-device search.  Linkage mode scores its small components round-robin
over the mesh and its large ones on a thread a device.  Fewer visible
devices than asked is logged and runs on one.
``tests/test_torch_parallel.py`` and ``tests/test_torch_sharded.py`` hold
labels, medoids and CLI bytes against the JAX package's ``devices=N`` at
N = 2, 4 and 8.  The exact index does not hash: the JAX package's chain
hashes every block into vectors that index never reads.  The IVF index
takes one retrieval in both packages; ``tests/test_torch_ivf.py`` holds
its labels against the JAX package's.
"""

import contextlib
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import (resolve_device, synchronize, visible_devices,
                      worker_stream)
from ..ops import medoids as medoid_ops
from ..ops import pairwise
from ..ops.density import dbscan
from ..ops.exact_knn import exact_banded_topk
from ..ops.ivf import IVFIndex
from ..ops.knn import NEG, _pow2_at_least, knn_banded
from ..ops.matching import f32_tolerance
from ..ops.rerank import rerank_exact
from ..ops.vectorize import SpectrumHasher, normalize_rows
from ..ops.xfer import upload_padded_peaks
from ..parallel.mesh import Mesh
from ..parallel.sharded_exact_index import exact_banded_topk_sharded
from ..parallel.sharded_ivf import ivf_search_sharded
from ..parallel.sharded_knn import knn_banded_sharded
from ..parallel.sharded_pipeline import (ann_cluster_sharded,
                                         sharded_medoid_scores)
from ..store.store import ChargeDataset, padded_peaks
from ..utils.profiling import profiler
from .grouped import score_and_link
from .intervals import mass_diff, precursor_mz_splits
from .postprocess import cluster_group_slices, postprocess_cluster

logger = logging.getLogger("falcon_tpu")

# Largest eps-component scored by the grouped kernel (K4); larger ones go
# to the pruned pair lists or K1.  Default of linkage_group_max().
LINKAGE_GROUP_MAX = 1024
# Most candidates per row the upper-bound scan may retrieve: dense bands
# widen n_neighbors_ann up to it, and a band beyond it is logged.  Default
# of max_neighbors().
MAX_NEIGHBORS = 1024


def linkage_group_max() -> int:
    """Largest eps-component scored by K4 (``FALCON_TPU_LINKAGE_GROUP_MAX``,
    default ``LINKAGE_GROUP_MAX``)."""
    return int(os.environ.get("FALCON_TPU_LINKAGE_GROUP_MAX",
                              LINKAGE_GROUP_MAX))


def max_neighbors() -> int:
    """The scan's neighbour budget (``FALCON_TPU_MAX_NEIGHBORS``, default
    ``MAX_NEIGHBORS``)."""
    return int(os.environ.get("FALCON_TPU_MAX_NEIGHBORS", MAX_NEIGHBORS))


def scan_bf16() -> bool:
    """The default index's upper-bound scan on bfloat16 operands (default);
    ``FALCON_TPU_KNN_DTYPE=f32`` scans float32 ones, TF32 refused, and
    drops the 1% bfloat16 margin from the compaction threshold.  Paths
    that threshold eps on the scan's own scores always scan float32."""
    return os.environ.get("FALCON_TPU_KNN_DTYPE", "bf16") != "f32"


def linkage_prune() -> bool:
    """Large components under complete or single linkage score only the
    pairs whose bound can reach ``1 - eps`` (default);
    ``FALCON_TPU_LINKAGE_PRUNE=0`` scores every pair with K1."""
    return os.environ.get("FALCON_TPU_LINKAGE_PRUNE", "1") != "0"


def ivf_coarse_spread() -> bool:
    """The IVF quantizer trains, assigns and probes on the normalised
    spread vectors (default); ``FALCON_TPU_IVF_COARSE=plain`` on the
    index's own vectors."""
    return os.environ.get("FALCON_TPU_IVF_COARSE", "spread") == "spread"


def ivf_rank_ub() -> bool:
    """Under the rerank, the IVF scan ranks the upper bounds
    ``spread_i . plain_j`` (default); ``FALCON_TPU_IVF_RANK=cos`` ranks the
    cosines of the unit plain vectors."""
    return os.environ.get("FALCON_TPU_IVF_RANK", "ub") == "ub"


def device_block_cap() -> int:
    """Spectra per device block (``FALCON_TPU_DEVICE_BLOCK_CAP``, default
    2^19), the JAX package's rule, so both packages cut a bucket at the
    same places.  The CLI overlaps two charges only when each fits one
    block.  The value was measured for a 16 GB TPU; the H100's is not
    measured yet."""
    return int(os.environ.get("FALCON_TPU_DEVICE_BLOCK_CAP", 2**19))


def block_pipeline_depth() -> int:
    """Device blocks of one charge in flight on one device
    (``FALCON_TPU_BLOCK_PIPELINE``, default 2, the JAX package's knob): one
    block's host refinement overlaps the next block's device work; 1 runs
    the blocks one after another."""
    return int(os.environ.get("FALCON_TPU_BLOCK_PIPELINE", "2"))


def _block_splits(mz_sorted: np.ndarray, tol_mass: float, tol_mode: str,
                  cap: int) -> np.ndarray:
    """Block boundaries: tolerance gaps, coalesced greedily up to
    ``cap`` spectra per block; a gap-free run longer than ``cap`` is cut
    inside and the cut is logged."""
    n = len(mz_sorted)
    if n <= cap:
        return np.asarray([0, n], np.int64)
    raw = precursor_mz_splits(mz_sorted, tol_mass, tol_mode, cap)
    splits = [int(raw[0])]
    for i in range(1, len(raw)):
        nxt = int(raw[i + 1]) if i + 1 < len(raw) else None
        if nxt is None or nxt - splits[-1] > cap:
            splits.append(int(raw[i]))
    splits = np.asarray(splits, np.int64)
    logger.info("Charge bucket of %d spectra split into %d device blocks "
                "(cap %d)", n, len(splits) - 1, cap)
    interior = splits[1:-1]
    if len(interior):
        diffs = mass_diff(mz_sorted[interior], mz_sorted[interior - 1],
                          tol_mode == "Da")
        n_forced = int((diffs <= tol_mass).sum())
        if n_forced:
            logger.warning(
                "%d of %d device-block boundaries are forced mid-run cuts "
                "(no tolerance gap at the boundary): within-tolerance pairs "
                "across those cuts are not compared", n_forced,
                len(interior))
    return splits


def generate_clusters(
    dataset: ChargeDataset,
    eps: float,
    min_samples: int,
    min_matches: int,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    fragment_tol: float,
    batch_size: int,
    low_dim: int = 400,
    n_neighbors: int = 64,
    n_neighbors_ann: int = 128,
    n_probe: int = 32,
    hash_seed: int = 0,
    min_mz: float = 101.0,
    max_mz: float = 1500.0,
    max_peaks: int = 50,
    devices: Optional[int] = None,
    ann_index: str = "auto",
    rerank: str = "exact",
    cluster_method: str = "linkage",
    linkage: str = "complete",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster one charge bucket; returns (labels, medoid row indices).

    The contract of ``falcon_tpu.cluster.ann_engine.generate_clusters``:
    every spectrum labelled, noise as singletons, one medoid per cluster
    plus each noise point.  ``min_samples`` is DBSCAN's core threshold
    under ``cluster_method="dbscan"`` (linkage mode ignores it, as the
    JAX package does).  ``low_dim`` and ``hash_seed`` shape the
    hashed vectors (the scan's, the pruned linkage bound's and, under
    ``rerank="off"``, the scan's cosines and the medoids');
    ``n_neighbors_ann`` is the scan's retrieval width before widening;
    ``n_probe`` the lists each IVF query scans (``ann_index="ivf"``);
    ``device``: see ``falcon_tpu_torch.device.resolve_device``.
    """
    if ann_index not in ("auto", "brute", "exact", "ivf"):
        raise ValueError(f"ann_index must be 'auto', 'brute', 'exact' or "
                         f"'ivf', got {ann_index!r}")
    if rerank not in ("exact", "off"):
        raise ValueError(f"rerank must be 'exact' or 'off', got {rerank!r}")
    if cluster_method not in ("linkage", "dbscan"):
        raise ValueError(f"cluster_method must be 'linkage' or 'dbscan', "
                         f"got {cluster_method!r}")
    dev = resolve_device(device)
    mesh = None
    if devices is not None and devices > 1:
        visible = visible_devices(dev)
        if len(visible) < devices:
            logger.warning("Requested %d devices but only %d visible; using "
                           "one device", devices, len(visible))
        else:
            mesh = Mesh(tuple(visible[:devices]))

    with profiler.phase("ann: load"):
        meta = dataset.read_metadata(
            columns=("precursor_mz", "retention_time"))
        offsets, mz_flat, int_flat = dataset.read_peaks()
        n = len(meta["precursor_mz"])
        precursor_mzs = np.asarray(meta["precursor_mz"], np.float64)
        rts = np.asarray(meta["retention_time"], np.float64)
        order = np.argsort(precursor_mzs, kind="stable")
        mz_sorted = precursor_mzs[order]
        rt_sorted = rts[order]
    logger.info(
        "Cluster %d spectra with the ANN engine (%s index, eps=%.3f, "
        "min_samples=%d, low_dim=%d, n_neighbors=%d)", n, ann_index, eps,
        min_samples, low_dim, n_neighbors)
    if n == 1:
        return np.zeros(1, np.int32), np.zeros(1, np.int64)

    hasher = SpectrumHasher(min_mz, max_mz, fragment_tol, low_dim, hash_seed)
    pad_to = ((max_peaks + 63) // 64) * 64
    splits = _block_splits(mz_sorted, precursor_tol_mass, precursor_tol_mode,
                           device_block_cap())

    block_ranges = [(b0, b1) for b0, b1 in zip(splits[:-1].tolist(),
                                               splits[1:].tolist())
                    if b1 > b0]
    multi_blocks = [b for b in block_ranges if b[1] - b[0] > 1]
    # Blocks share no state, so they may run at once: round-robin over the
    # mesh's devices, each block on one device (no collectives), or a
    # pipeline of block_pipeline_depth() blocks on one device, each worker
    # on a stream of its own.  Results merge in block order, so the labels
    # are the serial loop's.
    block_devices = None
    n_workers = 1
    if len(multi_blocks) > 1:
        if mesh is not None:
            block_devices = mesh.devices
            n_workers = min(mesh.size, len(multi_blocks))
            logger.info("Dispatching %d device blocks round-robin over %d "
                        "devices", len(multi_blocks), mesh.size)
        else:
            n_workers = min(block_pipeline_depth(), len(multi_blocks))

    def run_block(i, b0, b1):
        d = block_devices[i % len(block_devices)] if block_devices else dev
        # The gauge's highest level shows how many blocks overlapped.
        with (worker_stream(d) if n_workers > 1
              else contextlib.nullcontext()), \
                profiler.gauge("ann.blocks_in_flight"):
            return _cluster_range(
                offsets, mz_flat, int_flat, order[b0:b1], mz_sorted[b0:b1],
                rt_sorted[b0:b1], hasher, pad_to, eps, min_samples,
                min_matches, precursor_tol_mass, precursor_tol_mode, rt_tol,
                fragment_tol, n_neighbors, n_neighbors_ann, n_probe,
                ann_index, rerank, cluster_method, linkage, batch_size, d,
                # Blocks spread over the mesh supersede the sharded chain.
                None if block_devices is not None else mesh)

    if n_workers > 1:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            futures = {b: pool.submit(profiler.bind(run_block), i, *b)
                       for i, b in enumerate(multi_blocks)}
            results = {b: futures[b].result() for b in multi_blocks}
    else:
        results = {b: run_block(i, *b) for i, b in enumerate(multi_blocks)}

    labels_sorted = np.full(n, -1, np.int32)
    medoids_all = []
    current = 0
    for b0, b1 in block_ranges:
        if b1 - b0 == 1:
            medoids_all.append(order[b0:b1].astype(np.int64))
            continue
        final_b, med_b = results[(b0, b1)]
        mask = final_b >= 0
        final_b = final_b.astype(np.int32)
        final_b[mask] += current
        if mask.any():
            current = int(final_b[mask].max()) + 1
        labels_sorted[b0:b1] = final_b
        medoids_all.append(med_b)

    noise_mask = labels_sorted == -1
    n_noise = int(noise_mask.sum())
    logger.info("%d spectra grouped in %d clusters, %d spectra remain as "
                "singletons", int((~noise_mask).sum()), current, n_noise)
    labels_sorted[noise_mask] = np.arange(current, current + n_noise,
                                          dtype=np.int32)
    labels_out = np.empty(n, np.int32)
    labels_out[order] = labels_sorted
    medoids = (np.concatenate(medoids_all) if medoids_all
               else np.zeros(0, np.int64))
    return labels_out, medoids


def _cluster_range(offsets, mz_flat, int_flat, order, mz_sorted, rt_sorted,
                   hasher, pad_to, eps, min_samples, min_matches,
                   precursor_tol_mass, precursor_tol_mode, rt_tol,
                   fragment_tol, n_neighbors, n_neighbors_ann, n_probe,
                   ann_index, rerank, cluster_method, linkage, batch_size,
                   dev, mesh=None):
    """Cluster one device block (a sorted precursor-m/z range) on ``dev``,
    or sharded over ``mesh`` (a ``parallel.mesh.Mesh``, or None).

    Returns (labels in sorted-range order, -1 = noise, numbered from 0;
    medoid dataset-row ids, noise singletons first)."""
    n = len(order)
    # Linkage mode: min_samples = 1 makes every point core, so DBSCAN
    # reduces to the components of the eps-graph; linkage inside them does
    # the rest.
    if cluster_method == "linkage":
        min_samples = 1
    k_final = min(n_neighbors, max(n - 1, 1))
    exact_index = ann_index == "exact"
    do_rerank = rerank == "exact" and not exact_index
    labels = None
    if mesh is not None and do_rerank and ann_index != "ivf":
        # The whole chain sharded over the mesh (the exact and IVF indexes
        # shard their searches only); the JAX package's hashed medoid
        # scores.
        with profiler.phase("ann: sharded pipeline"):
            mz_host, int_host, _ = padded_peaks(offsets, mz_flat, int_flat,
                                                pad_to, order)
            result = ann_cluster_sharded(
                mz_host, int_host, mz_sorted,
                rt_sorted if rt_tol is not None else None, hasher,
                precursor_tol_mass, precursor_tol_mode,
                min(max(n_neighbors_ann, k_final), max(n - 1, 1)), k_final,
                fragment_tol, eps, min_samples, min_matches, rt_tol, mesh)
        if result is None:
            logger.warning("Precursor band wider than one shard halo; "
                           "falling back to the single-device pipeline")
        else:
            labels, vectors, _ = result

            def medoid_scores(seg, n_seg):
                return sharded_medoid_scores(vectors, seg, n_seg, mesh)
    if labels is None:
        labels, medoid_scores = _single_device_chain(
            offsets, mz_flat, int_flat, order, mz_sorted, rt_sorted, hasher,
            pad_to, eps, min_samples, min_matches, precursor_tol_mass,
            precursor_tol_mode, rt_tol, fragment_tol, k_final,
            n_neighbors_ann, n_probe, ann_index, do_rerank, dev, mesh,
            count=cluster_method == "dbscan")
    if cluster_method == "linkage":
        del medoid_scores
        return _linkage_refine_and_medoids(
            labels, order, mz_sorted, rt_sorted, n, offsets, mz_flat,
            int_flat, pad_to, linkage, eps, min_matches, fragment_tol,
            precursor_tol_mass, precursor_tol_mode, rt_tol, batch_size,
            hasher, dev, mesh.devices if mesh is not None else None)
    return _refine_and_medoids(labels, order, mz_sorted, rt_sorted, n,
                               precursor_tol_mass, precursor_tol_mode,
                               rt_tol, min_samples, medoid_scores)


def _single_device_chain(offsets, mz_flat, int_flat, order, mz_sorted,
                         rt_sorted, hasher, pad_to, eps, min_samples,
                         min_matches, precursor_tol_mass, precursor_tol_mode,
                         rt_tol, fragment_tol, k_final, n_neighbors_ann,
                         n_probe, ann_index, do_rerank, dev, mesh,
                         count=False):
    """The block's lists on ``dev`` and DBSCAN on them: (labels, medoid
    scores of (seg, n_seg), numpy).  With ``mesh`` set, the search runs
    sharded over it: the exact index (``parallel/sharded_exact_index.py``),
    the IVF ring (``parallel/sharded_ivf.py``) or, under ``--rerank off``,
    the halo k-NN; each falls back to one device, with the JAX package's
    warning, where that search returns None.  ``count``: DBSCAN keeps its
    recorder counters (dbscan mode; linkage mode records none)."""
    n = len(order)
    exact_index = ann_index == "exact"
    with profiler.phase("ann: upload"):
        mz_pad, int_pad = upload_padded_peaks(
            offsets, mz_flat, int_flat, order, pad_to,
            _pow2_at_least(n, 512), dev)
    unit = None
    if exact_index:
        with profiler.phase("ann: knn"):
            sims = None
            if mesh is not None:
                mz_host, int_host, _ = padded_peaks(offsets, mz_flat,
                                                    int_flat, pad_to, order)
                result = exact_banded_topk_sharded(
                    mz_host, int_host, mz_sorted, precursor_tol_mass,
                    precursor_tol_mode, k_final, fragment_tol, mesh,
                    rts=rt_sorted if rt_tol is not None else None,
                    rt_tol=rt_tol, min_matches=min_matches)
                if result is None:
                    logger.warning("Precursor band wider than one shard "
                                   "halo; falling back to the single-device "
                                   "exact index")
                else:
                    sims, neigh = result
            if sims is None:
                sims, neigh = exact_banded_topk(
                    mz_pad, int_pad, mz_sorted, precursor_tol_mass,
                    precursor_tol_mode, k_final, fragment_tol,
                    rts=rt_sorted if rt_tol is not None else None,
                    rt_tol=rt_tol, min_matches=min_matches)
            synchronize(dev)
    elif ann_index == "ivf":
        sims, neigh, unit = _ivf_lists(
            mz_pad, int_pad, mz_sorted, rt_sorted, hasher, min_matches,
            precursor_tol_mass, precursor_tol_mode, rt_tol, fragment_tol,
            k_final, n_neighbors_ann, n_probe, do_rerank, dev, mesh)
    elif do_rerank:
        sims, neigh = _prefilter_rerank(
            mz_pad, int_pad, mz_sorted, rt_sorted, hasher, eps, min_matches,
            precursor_tol_mass, precursor_tol_mode, rt_tol, fragment_tol,
            k_final, n_neighbors_ann, dev)
    else:
        # --rerank off: the exact top k_final of the hashed cosines, in
        # full float32 (eps is thresholded on them; TF32 is refused), of
        # vectors normalised in the JAX package's order.
        with profiler.phase("ann: vectorize"):
            unit = normalize_rows(hasher.vectorize(mz_pad, int_pad,
                                                   norm=False))
            synchronize(dev)
        with profiler.phase("ann: knn"):
            sims = None
            if mesh is not None:
                result = knn_banded_sharded(
                    unit, mz_sorted, precursor_tol_mass, precursor_tol_mode,
                    k_final, mesh)
                if result is None:
                    logger.warning("Precursor band wider than one shard "
                                   "halo; falling back to single-device "
                                   "k-NN")
                elif rt_tol is not None:
                    sims, neigh = _rt_filter(*result, rt_sorted, rt_tol)
                else:
                    sims, neigh = result
            if sims is None:
                sims, neigh = knn_banded(
                    unit, mz_sorted, precursor_tol_mass, precursor_tol_mode,
                    k_final, rts=rt_sorted, rt_tol=rt_tol)
            synchronize(dev)
    del mz_pad, int_pad
    with profiler.phase("ann: dbscan"):
        labels = dbscan(sims, neigh, eps, n, min_samples, count)

    def medoid_scores(seg, n_seg):
        """Scores of the rows (numpy, (n,)); ``seg`` puts noise in the
        spill segment ``n_seg - 1``."""
        if unit is None:
            # The lists hold exact similarities: medoids from the same
            # distances the clustering ran on.
            seg_pad = np.full(sims.shape[0], n_seg - 1, np.int32)
            seg_pad[:n] = seg
            seg_t = torch.from_numpy(seg_pad).to(dev)
            scores = medoid_ops.sparse_medoid_scores(
                sims.contiguous(), neigh.contiguous(), seg_t, n_seg - 1)
            if profiler.recording:
                # The listed pairs the launch scores: both rows in one
                # cluster (a device read, so only while recording).
                same = seg_t[neigh.clamp_min(0)] == seg_t[:, None]
                profiler.count("ann.medoids.listed", int(
                    ((neigh >= 0) & same & (seg_t != n_seg - 1)[:, None])
                    .sum()))
        else:
            # --rerank off clustered on the hashed cosines: medoids from
            # the same vectors.
            scores = medoid_ops.hashed_medoid_scores(
                unit, torch.from_numpy(seg.astype(np.int32)).to(dev),
                n_seg - 1)
        return scores[:n].cpu().numpy()

    return labels, medoid_scores


def _rt_filter(sims, neigh, rt_sorted, rt_tol):
    """(n, k) lists with the neighbours more than ``rt_tol`` away in
    retention time dropped (``NEG`` / -1), compared in float64 as the JAX
    package's NumPy filter of the IVF and sharded k-NN lists."""
    n = len(rt_sorted)
    rts = torch.as_tensor(rt_sorted, dtype=torch.float64, device=sims.device)
    neigh_rt = torch.where(neigh >= 0, rts[neigh.clamp(0, n - 1)], torch.inf)
    bad = (neigh_rt - rts[:neigh.shape[0], None]).abs() > rt_tol
    return torch.where(bad, NEG, sims), torch.where(bad, -1, neigh)


def band_spans(mz_sorted: np.ndarray, tol_mass: float,
               tol_mode: str) -> np.ndarray:
    """Spectra in each row's precursor band (itself included), the JAX
    package's host estimate."""
    if tol_mode == "Da":
        lo_vals, hi_vals = mz_sorted - tol_mass, mz_sorted + tol_mass
    else:
        lo_vals = mz_sorted / (1 + tol_mass / 1e6)
        hi_vals = mz_sorted / (1 - tol_mass / 1e6)
    return (np.searchsorted(mz_sorted, hi_vals, side="right")
            - np.searchsorted(mz_sorted, lo_vals, side="left"))


def widened_k(spans: np.ndarray, k_final: int,
              n_neighbors_ann: int) -> Tuple[int, int]:
    """The JAX package's ``k_ann`` of a rerank path and its count of
    boundary-continued passes: ``n_neighbors_ann`` (at least ``k_final``,
    at most ``n - 1``), widened in powers of two for dense bands up to its
    per-pass cap, then as many passes as cover ``max_neighbors()``
    candidates, with its log lines.  ``spans``: ``band_spans`` of the ``n``
    rows."""
    n = len(spans)
    k_ann = min(max(n_neighbors_ann, k_final), max(n - 1, 1))
    span_max = int(spans.max(initial=1)) - 1  # candidates excl. self
    if span_max <= k_ann:
        return k_ann, 1
    budget = max_neighbors()
    # The JAX package caps one pass's (rows, k) lists at 2^28 bytes, a
    # TPU fault limit, and covers the rest of the budget in more passes;
    # the port scans their total at once.
    per_pass = max(min(budget, 2**28 // (8 * _pow2_at_least(n, 512))), k_ann)
    new_k = k_ann
    while new_k < min(span_max, per_pass, max(n - 1, 1)):
        new_k *= 2
    new_k = min(new_k, max(n - 1, 1))
    if new_k > k_ann:
        logger.info(
            "Dense precursor bands (max %d candidates, %.1f%% of rows "
            "exceed n_neighbors_ann=%d): widening the retrieval width to %d "
            "(per-pass budget %d)", span_max,
            100.0 * float((spans - 1 > k_ann).mean()), k_ann, new_k,
            per_pass)
    k_ann, passes = new_k, 1
    if span_max > k_ann:
        passes = max(1, -(-min(budget, span_max, max(n - 1, 1)) // k_ann))
    if span_max > k_ann * passes:
        logger.warning(
            "%.1f%% of rows have more in-band candidates (max %d) than the "
            "neighbor budget %d; retrieval may truncate true neighbors in "
            "those bands (raise FALCON_TPU_MAX_NEIGHBORS or "
            "--n_neighbors_ann)",
            100.0 * float((spans - 1 > k_ann * passes).mean()), span_max,
            k_ann * passes)
    return k_ann, passes


def scan_width(mz_sorted: np.ndarray, tol_mass: float, tol_mode: str,
               k_final: int, n_neighbors_ann: int) -> int:
    """Candidates per row of the upper-bound scan: ``widened_k``'s width
    times its passes, at most ``n - 1``."""
    n = len(mz_sorted)
    k_ann, passes = widened_k(band_spans(mz_sorted, tol_mass, tol_mode),
                              k_final, n_neighbors_ann)
    return min(k_ann * passes, max(n - 1, 1))


def ivf_widths(spans: np.ndarray, k_final: int, n_neighbors_ann: int,
               do_rerank: bool) -> Tuple[int, int]:
    """``--ann_index ivf``'s (k_ann, k_ivf): the width its lists are cut
    to (``widened_k``'s, without its passes, under the rerank; else
    ``k_final``) and the k it searches (at least ``n_neighbors_ann``, at
    most ``n - 1``).  ``spans``: ``band_spans`` of the ``n`` rows."""
    n = len(spans)
    k_ann = (widened_k(spans, k_final, n_neighbors_ann)[0] if do_rerank
             else k_final)
    return k_ann, min(max(n_neighbors_ann, k_ann), max(n - 1, 1))


def compact_candidates(bounds: torch.Tensor, neigh: torch.Tensor,
                       eps: float, bf16: bool = True) -> torch.Tensor:
    """The scan's lists cut to the candidates the rerank must score: ids
    whose bound can reach ``1 - eps`` (a ``bf16`` scan reads a bound at
    most 1% low, so the threshold is ``(1 - eps) * 0.99 - 1e-3``, else
    ``(1 - eps) - 1e-3``, compared in float32), the rest -1, in a
    power-of-two width of at least 16.  The RT filter leaves holes in the
    bound-sorted lists, so the width comes from the last surviving column,
    not the survivor count.  One host sync."""
    keep = bounds >= f32_tolerance((1.0 - eps) * (0.99 if bf16 else 1.0)
                                   - 1e-3)
    cols = torch.arange(1, keep.shape[1] + 1, device=keep.device)
    width = _pow2_at_least(int(torch.where(keep, cols, 0).max()), 16)
    return torch.where(keep, neigh, -1)[:, :width].contiguous()


def _prefilter_rerank(mz_pad, int_pad, mz_sorted, rt_sorted, hasher, eps,
                      min_matches, precursor_tol_mass, precursor_tol_mode,
                      rt_tol, fragment_tol, k_final, n_neighbors_ann, dev):
    """The default index: (exact scores, ids) of each row's top
    ``k_final`` among the candidates whose spread upper bound can reach
    ``1 - eps``, padded lists as the exact index returns them."""
    k_scan = scan_width(mz_sorted, precursor_tol_mass, precursor_tol_mode,
                        k_final, n_neighbors_ann)
    bf16 = scan_bf16()
    with profiler.phase("ann: vectorize"):
        plain, spread = hasher.vectorize_pair(mz_pad, int_pad)
        synchronize(dev)
    with profiler.phase("ann: knn"):
        # spread_i . plain_j with unnormalised vectors bounds the exact
        # matched score from above (ops/vectorize.py); the bf16 scan reads
        # it at most 1% low (ops/knn.py), which the threshold allows for.
        sims, neigh = knn_banded(
            plain, mz_sorted, precursor_tol_mass, precursor_tol_mode,
            k_scan, rts=rt_sorted, rt_tol=rt_tol, q_vectors=spread,
            scan_bf16=bf16)
        del plain, spread
        synchronize(dev)
    with profiler.phase("ann: rerank"):
        sims, neigh, n_match = rerank_exact(
            mz_pad, int_pad, compact_candidates(sims, neigh, eps, bf16),
            fragment_tol, k_final)
        if min_matches > 0:
            sims = torch.where((neigh >= 0) & (n_match < min_matches), 0.0,
                               sims)
        synchronize(dev)
    return sims, neigh


def _ivf_lists(mz_pad, int_pad, mz_sorted, rt_sorted, hasher, min_matches,
               precursor_tol_mass, precursor_tol_mode, rt_tol, fragment_tol,
               k_final, n_neighbors_ann, n_probe, do_rerank, dev,
               mesh=None):
    """``--ann_index ivf`` (``falcon_tpu/cluster/ann_engine.py``,
    :830-912 and the rerank's compaction at :1082-1092): (scores, ids,
    unit vectors or None), the lists as the other indexes return them.
    With ``mesh`` set the search is the ring over it
    (``parallel/sharded_ivf.py``), unless the mesh does not divide the list
    count.

    The quantizer trains on the normalised spread vectors
    (``ivf_coarse_spread``), else on the index's own vectors.  With the
    rerank, the index holds the unnormalised plain vectors in bfloat16 and
    ranks the upper bounds ``spread_i . plain_j`` (``ivf_rank_ub``), else
    the unit plain vectors in bfloat16, ranked by their cosines; the
    lists, cut to ``k_ann`` and filtered by RT, are scored exactly in their
    first power-of-two (at least 16) columns covering the widest band.
    Without it, the index holds the unit plain vectors in float32 and its
    cosines, cut to ``k_final``, are the lists (and the unit vectors are
    returned for the medoids).  Inside ``ann: knn`` the search is the
    phase ``ivf: probe`` (synchronised while the recorder is on) and the
    cut with the RT filter ``ivf: cut`` (synchronised); the recorder counts
    the rerank's width as ``ann.rerank.width``."""
    n = len(mz_sorted)
    spans = band_spans(mz_sorted, precursor_tol_mass, precursor_tol_mode)
    k_ann, k_ivf = ivf_widths(spans, k_final, n_neighbors_ann, do_rerank)
    coarse_spread = ivf_coarse_spread()
    rank_ub = do_rerank and ivf_rank_ub()
    with profiler.phase("ann: vectorize"):
        if coarse_spread or rank_ub:
            plain, spread = hasher.vectorize_pair(mz_pad, int_pad)
        else:
            plain, spread = hasher.vectorize(mz_pad, int_pad,
                                             norm=False), None
        # Without the spread vectors the quantizer takes the index's own
        # vectors: under the upper-bound ranking, the unnormalised plain
        # ones (as the JAX package does).
        coarse = normalize_rows(spread) if coarse_spread else None
        vectors, rank = ((plain, spread) if rank_ub
                         else (normalize_rows(plain), None))
        synchronize(dev)
    with profiler.phase("ann: knn"):
        index = IVFIndex(vectors, mz_sorted, n_lists=None, seed=42,
                         precise=not do_rerank, coarse_vectors=coarse,
                         rank_vectors=rank)
        del coarse, spread, rank
        with profiler.phase("ivf: probe"):
            result = None
            if mesh is not None:
                result = ivf_search_sharded(
                    index, k_ivf, n_probe, precursor_tol_mass,
                    precursor_tol_mode, mesh, precise=not do_rerank)
                if result is None:
                    logger.warning("Mesh size does not divide the IVF list "
                                   "count; falling back to the "
                                   "single-device list scan")
            sims, neigh = (result if result is not None
                           else index.self_search(
                               k_ivf, n_probe=n_probe,
                               tol_mass=precursor_tol_mass,
                               tol_mode=precursor_tol_mode,
                               precise=not do_rerank))
            if profiler.recording:
                synchronize(dev)
        del index, plain
        with profiler.phase("ivf: cut"):
            sims, neigh = sims[:, :k_ann], neigh[:, :k_ann].long()
            if rt_tol is not None:
                sims, neigh = _rt_filter(sims, neigh, rt_sorted, rt_tol)
            synchronize(dev)
    if not do_rerank:
        return sims.contiguous(), neigh, vectors
    del vectors
    with profiler.phase("ann: rerank"):
        # The lists are sorted by bound with -1 at the tail: score the
        # columns that the widest band can fill.
        real_k = max(min(int(spans.max(initial=1)) - 1, k_ann), 1)
        width = min(_pow2_at_least(real_k, 16), neigh.shape[1])
        profiler.count("ann.rerank.width", width)
        ids = torch.full((mz_pad.shape[0], width), -1, dtype=torch.int64,
                         device=dev)
        ids[:n] = neigh[:, :width]
        sims, neigh, n_match = rerank_exact(
            mz_pad, int_pad, ids, fragment_tol, k_final)
        if min_matches > 0:
            sims = torch.where((neigh >= 0) & (n_match < min_matches), 0.0,
                               sims)
        synchronize(dev)
    return sims, neigh, None


def _linkage_refine_and_medoids(
    comp, order, mz_sorted, rt_sorted, n, offsets, mz_flat, int_flat,
    pad_to, linkage, eps, min_matches, fragment_tol, precursor_tol_mass,
    precursor_tol_mode, rt_tol, batch_size, hasher, dev, devices=None,
):
    """The reference's hierarchical clustering inside eps-components.

    A copy of the JAX engine's ``_linkage_refine_and_medoids`` (whose
    module imports JAX): ``comp`` labels each row with its eps-connected
    component (-1 = none); each component, capped at ``batch_size``
    spectra like a reference interval, is linked, cut at ``eps`` and
    refined, with medoids from its exact distances.  A flat cluster of a
    reducible linkage cut at eps lies inside one single-linkage component
    at eps, so this gives the full-matrix flat clusters.  ``devices`` (a
    list, or None for ``dev`` alone): the small components' launches go
    round-robin over them, and one host thread per device scores its share
    of the large ones.  Scoring and linking are the stage both engines
    share (``cluster/grouped.py``); the components are assembled in their
    order.
    """
    with profiler.phase("ann: components"):
        comp = np.asarray(comp, np.int64)
        order2 = np.argsort(comp, kind="stable")
        sorted_comp = comp[order2].astype(np.int32)
        slices = [(s, e) for s, e in cluster_group_slices(sorted_comp)
                  if sorted_comp[s] >= 0]
        positions = [order2[s:e] for s, e in slices]
        noise_pos = order2[sorted_comp == -1]

        capped, n_chunked = [], 0
        for pos in positions:
            if len(pos) <= batch_size:
                capped.append(pos)
            else:
                n_chunks = -(-len(pos) // batch_size)
                bounds = np.linspace(0, len(pos),
                                     n_chunks + 1).astype(np.int64)
                capped.extend(pos[a:b]
                              for a, b in zip(bounds[:-1], bounds[1:]))
                n_chunked += 1
        if n_chunked:
            logger.warning(
                "%d eps-component(s) exceeded batch_size=%d and were "
                "chunked for linkage (reference batch_size semantics: "
                "within-tolerance pairs across chunk boundaries are not "
                "compared)", n_chunked, batch_size)
        positions = capped

        member_pos = (np.concatenate(positions) if positions
                      else np.zeros(0, np.int64))
        sizes = np.asarray([len(p) for p in positions], np.int64)
        comp_off = np.zeros(len(positions) + 1, np.int64)
        np.cumsum(sizes, out=comp_off[1:])

    # Complete and single linkage cut at eps never read a distance above
    # eps, so large components score only the pairs whose spread bound can
    # reach 1 - eps; average linkage needs every distance.  The pruned
    # distances above eps read 1.0, so a single-linkage medoid can differ
    # from the unpruned one's.
    prune = linkage in ("complete", "single") and linkage_prune()

    def score_large(mz_c, int_c, d):
        if prune:
            return pairwise.pruned_condensed_distances(
                mz_c, int_c, hasher, eps, fragment_tol, min_matches, device=d)
        return pairwise.condensed_distances(mz_c, int_c, fragment_tol,
                                            min_matches, device=d)

    with profiler.phase("ann: linkage"):
        linked = score_and_link(
            offsets, mz_flat, int_flat, pad_to, order[member_pos], comp_off,
            mz_sorted[member_pos],
            rt_sorted[member_pos] if rt_tol is not None else None, linkage,
            eps, precursor_tol_mass, precursor_tol_mode, rt_tol, min_matches,
            fragment_tol, linkage_group_max(), score_large, dev, devices)

    with profiler.phase("ann: refine"):
        # Assemble in component order, so labels do not depend on the
        # order the components were scored in: each component's labels
        # after those of the components before it, and its medoids after
        # theirs, the rows outside every component first.
        offset = np.repeat(np.cumsum(linked.n_clusters) - linked.n_clusters,
                           sizes)
        final = np.full(n, -1, np.int32)
        final[member_pos] = np.where(linked.labels >= 0,
                                     linked.labels + offset, -1)
        medoids = np.concatenate([order[noise_pos].astype(np.int64),
                                  linked.medoids])
    return final, medoids


def _refine_and_medoids(labels, order, mz_sorted, rt_sorted, n,
                        precursor_tol_mass, precursor_tol_mode, rt_tol,
                        min_samples, medoid_scores_fn):
    """DBSCAN mode's tail: host refinement, medoid selection.

    A copy of the JAX engine's ``_refine_and_medoids`` (whose module
    imports JAX), without its stage timer: the precursor m/z / RT
    refinement of each cluster (clusters inside the span are kept whole or
    demoted below ``max(min_samples, 2)`` members), then per cluster the
    first row with the largest ``medoid_scores_fn(seg, n_seg + 1)`` score,
    noise in the spill segment ``n_seg``.  The recorder keeps
    ``ann.refine.clusters`` (clusters kept), ``ann.refine.split``
    (clusters out of the precursor / RT span, sent through
    ``postprocess_cluster``) and ``ann.refine.demoted`` (clusters left
    with no group of ``max(min_samples, 2)`` members)."""
    with profiler.phase("ann: refine"):
        # 4. Refinement: precursor m/z / RT splitting per cluster,
        # identical semantics to the exact engine.
        order2 = np.argsort(labels, kind="stable")
        sorted_labels = labels[order2].astype(np.int32)
        mzs_interval = mz_sorted[order2]
        rts_interval = rt_sorted[order2]
        current_label = 0
        slices = list(cluster_group_slices(sorted_labels))
        # Vectorized no-split fast path: a cluster whose precursor m/z
        # span (and RT span) is within tolerance cannot be split by the
        # 1-D complete-linkage cut (its root merge distance IS the span),
        # so the expensive per-cluster machinery only runs on the rare
        # out-of-span clusters.  min_samples demotion semantics preserved.
        starts = np.asarray([s for s, _ in slices], np.int64)
        mz_min_ = np.minimum.reduceat(mzs_interval, starts)
        mz_max_ = np.maximum.reduceat(mzs_interval, starts)
        if precursor_tol_mode == "ppm":
            mz_ok = (mz_max_ - mz_min_) / np.maximum(mz_min_, 1e-12) \
                * 1e6 <= precursor_tol_mass
        else:
            mz_ok = (mz_max_ - mz_min_) <= precursor_tol_mass
        if rt_tol is not None:
            rt_min_ = np.minimum.reduceat(rts_interval, starts)
            rt_max_ = np.maximum.reduceat(rts_interval, starts)
            mz_ok &= (rt_max_ - rt_min_) <= rt_tol
        min_samples_eff = max(min_samples, 2)
        n_split = n_demoted = 0
        for k_i, (start_i, stop_i) in enumerate(slices):
            if sorted_labels[start_i] == -1:
                continue
            if mz_ok[k_i]:
                if stop_i - start_i < min_samples_eff:
                    sorted_labels[start_i:stop_i] = -1
                    n_demoted += 1
                else:
                    sorted_labels[start_i:stop_i] = current_label
                    current_label += 1
                continue
            n_clusters = postprocess_cluster(
                sorted_labels[start_i:stop_i],
                mzs_interval[start_i:stop_i],
                rts_interval[start_i:stop_i],
                precursor_tol_mass, precursor_tol_mode, rt_tol,
                min_samples_eff, current_label,
            )
            current_label += n_clusters
            n_split += 1
            n_demoted += n_clusters == 0
        profiler.count("ann.refine.clusters", current_label)
        profiler.count("ann.refine.split", n_split)
        profiler.count("ann.refine.demoted", n_demoted)

        final = np.full(n, -1, np.int32)
        final[order2] = sorted_labels

    with profiler.phase("ann: medoids"):
        # 5. Medoids: per cluster, the first row with the largest score.
        order3 = np.argsort(final, kind="stable")
        sorted_final = final[order3]
        n_seg = int(final.max()) + 1 if final.max() >= 0 else 1
        # Noise points go to a dedicated spill segment (n_seg) so they
        # never pollute a real cluster's sum.
        seg = np.where(final >= 0, final, n_seg).astype(np.int32)
        scores = medoid_scores_fn(seg, n_seg + 1)
        # Vectorized per-cluster argmax (first-max-by-row tie-breaking):
        # noise singletons represent themselves and come first, mirroring
        # cluster_group_slices iteration order.
        noise_rows = order3[sorted_final == -1]
        pos_rows = order3[sorted_final >= 0]
        if len(pos_rows):
            lab = final[pos_rows]
            lex = np.lexsort((-pos_rows, scores[pos_rows], lab))
            sorted_lab = lab[lex]
            ends = np.flatnonzero(
                np.diff(sorted_lab, append=sorted_lab[-1] + 1)
            )
            best = pos_rows[lex][ends]
        else:
            best = np.zeros(0, np.int64)
        # Convert positions in the sorted order back to dataset row
        # indices.
        medoids = order[np.concatenate([noise_rows, best]).astype(np.int64)]
    return final, medoids
