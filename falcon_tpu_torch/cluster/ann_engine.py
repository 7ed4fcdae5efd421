"""Per-charge clustering with the ann backend's exact index, on PyTorch.

Port of ``falcon_tpu/cluster/ann_engine.py`` for ``--backend ann
--ann_index exact`` with ``--cluster_method linkage``, the same labels and
medoids:

1. sort the bucket by precursor m/z and split it into device blocks of at
   most ``device_block_cap()`` spectra on tolerance gaps (logging every
   forced cut), clustered one after the other and merged in block order;
2. per block: pad and upload the peaks (``ops/xfer.py``), take each row's
   exact top-k neighbours in the precursor band (``ops/exact_knn.py``,
   kernel K2), and find the eps-connected components (``ops/density.py``
   with ``min_samples = 1``);
3. per component, as one exact-engine interval: condensed exact distances
   (K4 for components of up to ``LINKAGE_GROUP_MAX`` spectra; larger ones
   through the pruned pair lists under complete or single linkage, or K1),
   then the native linkage, the cut at eps, the precursor / RT
   refinement and the medoids.

The JAX exact-index path also hashes the block into vectors that this
index never reads; the port does not.  Other indexes (``auto``,
``brute``, ``ivf``) and ``--cluster_method dbscan`` are not ported yet and
raise ``NotImplementedError``.
"""

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device, synchronize
from ..ops import pairwise
from ..ops.density import dbscan
from ..ops.exact_knn import exact_banded_topk
from ..ops.knn import _pow2_at_least
from ..ops.vectorize import SpectrumHasher
from ..ops.xfer import upload_padded_peaks
from ..store.store import ChargeDataset, padded_peaks
from ..utils.profiling import profiler
from .intervals import mass_diff, precursor_mz_splits
from .postprocess import (
    cluster_group_slices,
    cluster_medoids,
    postprocess_cluster,
)

logger = logging.getLogger("falcon_tpu")

# Largest eps-component scored by the grouped kernel (K4); larger ones go
# to the pruned pair lists or K1.  The JAX package reads the same default
# from FALCON_TPU_LINKAGE_GROUP_MAX.
LINKAGE_GROUP_MAX = 1024


def device_block_cap() -> int:
    """Spectra per device block (``FALCON_TPU_DEVICE_BLOCK_CAP``, default
    2^19), the JAX package's rule, so both packages cut a bucket at the
    same places.  The CLI overlaps two charges only when each fits one
    block.  The value was measured for a 16 GB TPU; the H100's is not
    measured yet."""
    return int(os.environ.get("FALCON_TPU_DEVICE_BLOCK_CAP", 2**19))


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
    min_matches: int,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    fragment_tol: float,
    batch_size: int,
    low_dim: int = 400,
    n_neighbors: int = 64,
    hash_seed: int = 0,
    min_mz: float = 101.0,
    max_mz: float = 1500.0,
    max_peaks: int = 50,
    devices: Optional[int] = None,
    ann_index: str = "exact",
    cluster_method: str = "linkage",
    linkage: str = "complete",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster one charge bucket; returns (labels, medoid row indices).

    The contract of ``falcon_tpu.cluster.ann_engine.generate_clusters``:
    every spectrum labelled, noise as singletons, one medoid per cluster
    plus each noise point.  ``low_dim`` and ``hash_seed`` shape the
    vectors of the pruned linkage bound; ``device``: see
    ``falcon_tpu_torch.device.resolve_device``.
    """
    if ann_index != "exact":
        raise NotImplementedError(
            f"--ann_index {ann_index} is not yet ported to falcon_tpu_torch")
    if cluster_method != "linkage":
        raise NotImplementedError(
            f"--cluster_method {cluster_method} is not yet ported to "
            "falcon_tpu_torch")
    dev = resolve_device(device)
    if devices is not None and devices > 1:
        visible = torch.cuda.device_count() if dev.type == "cuda" else 1
        if visible >= devices:
            raise NotImplementedError(
                "multi-device ann clustering is not ported yet")
        logger.warning("Requested %d devices but only %d visible; using "
                       "the single-device exact index", devices, visible)

    meta = dataset.read_metadata(columns=("precursor_mz", "retention_time"))
    offsets, mz_flat, int_flat = dataset.read_peaks()
    n = len(meta["precursor_mz"])
    precursor_mzs = np.asarray(meta["precursor_mz"], np.float64)
    rts = np.asarray(meta["retention_time"], np.float64)
    order = np.argsort(precursor_mzs, kind="stable")
    mz_sorted = precursor_mzs[order]
    rt_sorted = rts[order]
    logger.info(
        "Cluster %d spectra with the ANN engine's exact index (eps=%.3f, "
        "n_neighbors=%d)", n, eps, n_neighbors)
    if n == 1:
        return np.zeros(1, np.int32), np.zeros(1, np.int64)

    hasher = SpectrumHasher(min_mz, max_mz, fragment_tol, low_dim, hash_seed)
    pad_to = ((max_peaks + 63) // 64) * 64
    splits = _block_splits(mz_sorted, precursor_tol_mass, precursor_tol_mode,
                           device_block_cap())

    labels_sorted = np.full(n, -1, np.int32)
    medoids_all = []
    current = 0
    for b0, b1 in zip(splits[:-1].tolist(), splits[1:].tolist()):
        if b1 - b0 == 0:
            continue
        if b1 - b0 == 1:
            medoids_all.append(order[b0:b1].astype(np.int64))
            continue
        final_b, med_b = _cluster_range(
            offsets, mz_flat, int_flat, order[b0:b1], mz_sorted[b0:b1],
            rt_sorted[b0:b1], hasher, pad_to, eps, min_matches,
            precursor_tol_mass, precursor_tol_mode, rt_tol, fragment_tol,
            n_neighbors, linkage, batch_size, dev)
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
                   hasher, pad_to, eps, min_matches, precursor_tol_mass,
                   precursor_tol_mode, rt_tol, fragment_tol, n_neighbors,
                   linkage, batch_size, dev):
    """Cluster one device block (a sorted precursor-m/z range).

    Returns (labels in sorted-range order, -1 = noise, numbered from 0;
    medoid dataset-row ids, noise singletons first)."""
    n = len(order)
    # min_samples = 1 makes every point core, so DBSCAN reduces to the
    # components of the eps-graph; linkage inside them does the rest.
    k_final = min(n_neighbors, max(n - 1, 1))
    with profiler.phase("ann: upload"):
        mz_pad, int_pad = upload_padded_peaks(
            offsets, mz_flat, int_flat, order, pad_to,
            _pow2_at_least(n, 512), dev)
    with profiler.phase("ann: knn"):
        sims, neigh = exact_banded_topk(
            mz_pad, int_pad, mz_sorted, precursor_tol_mass,
            precursor_tol_mode, k_final, fragment_tol,
            rts=rt_sorted if rt_tol is not None else None, rt_tol=rt_tol,
            min_matches=min_matches)
        synchronize(dev)
    del mz_pad, int_pad
    with profiler.phase("ann: dbscan"):
        comp = dbscan(sims, neigh, eps, n, 1)
    del sims, neigh
    return _linkage_refine_and_medoids(
        comp, order, mz_sorted, rt_sorted, n, offsets, mz_flat, int_flat,
        pad_to, linkage, eps, min_matches, fragment_tol, precursor_tol_mass,
        precursor_tol_mode, rt_tol, batch_size, hasher, dev)


def _linkage_refine_and_medoids(
    comp, order, mz_sorted, rt_sorted, n, offsets, mz_flat, int_flat,
    pad_to, linkage, eps, min_matches, fragment_tol, precursor_tol_mass,
    precursor_tol_mode, rt_tol, batch_size, hasher, dev,
):
    """The reference's hierarchical clustering inside eps-components.

    A copy of the JAX engine's ``_linkage_refine_and_medoids`` (whose
    module imports JAX): ``comp`` labels each row with its eps-connected
    component (-1 = none); each component, capped at ``batch_size``
    spectra like a reference interval, is linked, cut at ``eps`` and
    refined, with medoids from its exact distances.  A flat cluster of a
    reducible linkage cut at eps lies inside one single-linkage component
    at eps, so this gives the full-matrix flat clusters.
    """
    final = np.full(n, -1, np.int32)
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
            bounds = np.linspace(0, len(pos), n_chunks + 1).astype(np.int64)
            capped.extend(pos[a:b] for a, b in zip(bounds[:-1], bounds[1:]))
            n_chunked += 1
    if n_chunked:
        logger.warning(
            "%d eps-component(s) exceeded batch_size=%d and were chunked "
            "for linkage (reference batch_size semantics: within-tolerance "
            "pairs across chunk boundaries are not compared)", n_chunked,
            batch_size)
    positions = capped

    member_pos = (np.concatenate(positions) if positions
                  else np.zeros(0, np.int64))
    mz_all, int_all, _ = padded_peaks(offsets, mz_flat, int_flat, pad_to,
                                      order[member_pos])
    comp_off = np.zeros(len(positions) + 1, np.int64)
    np.cumsum([len(p) for p in positions], out=comp_off[1:])

    def comp_peaks(i):
        lo, hi = comp_off[i], comp_off[i + 1]
        return mz_all[lo:hi], int_all[lo:hi]

    per_comp = {}

    def process(i, pdist):
        """One component as one exact-engine interval."""
        pos = positions[i]
        size = len(pos)
        # Every distance within eps: any linkage cut at eps gives one
        # cluster, and if the precursor (and RT) span is within tolerance
        # the refinement keeps it whole too.
        if pdist.max(initial=0.0) <= eps:
            mzs_c = mz_sorted[pos]
            span = float(mzs_c.max() - mzs_c.min())
            if precursor_tol_mode == "ppm":
                span_ok = (span / max(float(mzs_c.min()), 1e-12) * 1e6
                           <= precursor_tol_mass)
            else:
                span_ok = span <= precursor_tol_mass
            if span_ok and rt_tol is not None:
                rts_c = rt_sorted[pos]
                span_ok = float(rts_c.max() - rts_c.min()) <= rt_tol
            if span_ok:
                lab = np.zeros(size, np.int32)
                med = cluster_medoids(order[pos].astype(np.int64), lab,
                                      pdist, np.arange(size))
                per_comp[i] = (pos, lab, 1, med)
                return
        z = native.linkage(pdist, linkage)
        flat = native.fcluster(z, eps, n=size)
        order1 = np.argsort(flat, kind="stable")
        sorted_labels = flat[order1].astype(np.int32)
        mzs_c = mz_sorted[pos[order1]]
        rts_c = rt_sorted[pos[order1]]
        current = 0
        for s_i, e_i in list(cluster_group_slices(sorted_labels)):
            current += postprocess_cluster(
                sorted_labels[s_i:e_i], mzs_c[s_i:e_i], rts_c[s_i:e_i],
                precursor_tol_mass, precursor_tol_mode, rt_tol, 2, current)
        order2b = np.argsort(sorted_labels, kind="stable")
        med = cluster_medoids(
            order[pos[order1][order2b]].astype(np.int64),
            sorted_labels[order2b], pdist, order1[order2b])
        per_comp[i] = (pos[order1], sorted_labels, current, med)

    small = [i for i in range(len(positions))
             if len(positions[i]) <= LINKAGE_GROUP_MAX]
    large = [i for i in range(len(positions))
             if len(positions[i]) > LINKAGE_GROUP_MAX]
    # Complete and single linkage cut at eps never read a distance above
    # eps, so large components score only the pairs whose spread bound can
    # reach 1 - eps; average linkage needs every distance.
    prune = linkage in ("complete", "single")
    with profiler.phase("ann: linkage"):
        if small:
            for local_i, pdist in pairwise.grouped_condensed_distances(
                    [comp_peaks(i) for i in small], fragment_tol,
                    min_matches, device=dev):
                process(small[local_i], pdist)
        for i in large:
            mz_c, int_c = comp_peaks(i)
            if prune:
                pdist = pairwise.pruned_condensed_distances(
                    mz_c, int_c, hasher, eps, fragment_tol, min_matches,
                    device=dev)
            else:
                pdist = pairwise.condensed_distances(
                    mz_c, int_c, fragment_tol, min_matches, device=dev)
            process(i, pdist)

    with profiler.phase("ann: refine"):
        # Assemble in component order, so labels do not depend on the
        # order the components were scored in.
        med_parts = [order[noise_pos].astype(np.int64)]
        current = 0
        for i in range(len(positions)):
            pos_lab, lab, n_cl, med = per_comp[i]
            mask = lab >= 0
            lab = lab.astype(np.int32)
            lab[mask] += current
            final[pos_lab] = lab
            current += n_cl
            med_parts.append(med)
        medoids = np.concatenate(med_parts)
    return final, medoids
