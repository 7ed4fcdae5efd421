"""Per-charge clustering with the ann backend, on PyTorch.

Port of ``falcon_tpu/cluster/ann_engine.py`` for ``--backend ann``, the
same labels and medoids:

1. sort the bucket by precursor m/z and split it into device blocks of at
   most ``device_block_cap()`` spectra on tolerance gaps (logging every
   forced cut), clustered one after the other and merged in block order;
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
its modes (certified, and forced exact multi-pass).  The exact index does
not hash: the JAX package's chain hashes every block into vectors that
index never reads.  ``--ann_index ivf`` is not ported yet and raises
``NotImplementedError``.
"""

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device, synchronize
from ..ops import medoids as medoid_ops
from ..ops import pairwise
from ..ops.density import dbscan
from ..ops.exact_knn import exact_banded_topk
from ..ops.knn import _pow2_at_least, knn_banded
from ..ops.matching import f32_tolerance
from ..ops.rerank import rerank_exact
from ..ops.vectorize import SpectrumHasher, normalize_rows
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
# Most candidates per row the upper-bound scan may retrieve (the JAX
# package's FALCON_TPU_MAX_NEIGHBORS default): dense bands widen
# n_neighbors_ann up to it, and a band beyond it is logged.
MAX_NEIGHBORS = 1024


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
    ``device``: see ``falcon_tpu_torch.device.resolve_device``.
    """
    if ann_index not in ("auto", "brute", "exact"):
        raise NotImplementedError(
            f"--ann_index {ann_index} is not yet ported to falcon_tpu_torch")
    if rerank not in ("exact", "off"):
        raise ValueError(f"rerank must be 'exact' or 'off', got {rerank!r}")
    if cluster_method not in ("linkage", "dbscan"):
        raise ValueError(f"cluster_method must be 'linkage' or 'dbscan', "
                         f"got {cluster_method!r}")
    dev = resolve_device(device)
    if devices is not None and devices > 1:
        visible = torch.cuda.device_count() if dev.type == "cuda" else 1
        if visible >= devices:
            raise NotImplementedError(
                "multi-device ann clustering is not ported yet")
        logger.warning("Requested %d devices but only %d visible; using "
                       "one device", devices, visible)

    meta = dataset.read_metadata(columns=("precursor_mz", "retention_time"))
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
            rt_sorted[b0:b1], hasher, pad_to, eps, min_samples, min_matches,
            precursor_tol_mass, precursor_tol_mode, rt_tol, fragment_tol,
            n_neighbors, n_neighbors_ann, ann_index == "exact", rerank,
            cluster_method, linkage, batch_size, dev)
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
                   fragment_tol, n_neighbors, n_neighbors_ann, exact_index,
                   rerank, cluster_method, linkage, batch_size, dev):
    """Cluster one device block (a sorted precursor-m/z range).

    Returns (labels in sorted-range order, -1 = noise, numbered from 0;
    medoid dataset-row ids, noise singletons first)."""
    n = len(order)
    # Linkage mode: min_samples = 1 makes every point core, so DBSCAN
    # reduces to the components of the eps-graph; linkage inside them does
    # the rest.
    if cluster_method == "linkage":
        min_samples = 1
    k_final = min(n_neighbors, max(n - 1, 1))
    do_rerank = rerank == "exact" and not exact_index
    with profiler.phase("ann: upload"):
        mz_pad, int_pad = upload_padded_peaks(
            offsets, mz_flat, int_flat, order, pad_to,
            _pow2_at_least(n, 512), dev)
    unit = None
    if exact_index:
        with profiler.phase("ann: knn"):
            sims, neigh = exact_banded_topk(
                mz_pad, int_pad, mz_sorted, precursor_tol_mass,
                precursor_tol_mode, k_final, fragment_tol,
                rts=rt_sorted if rt_tol is not None else None,
                rt_tol=rt_tol, min_matches=min_matches)
            synchronize(dev)
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
            sims, neigh = knn_banded(
                unit, mz_sorted, precursor_tol_mass, precursor_tol_mode,
                k_final, rts=rt_sorted, rt_tol=rt_tol)
            synchronize(dev)
    del mz_pad, int_pad
    with profiler.phase("ann: dbscan"):
        labels = dbscan(sims, neigh, eps, n, min_samples)
    if cluster_method == "linkage":
        del sims, neigh, unit
        return _linkage_refine_and_medoids(
            labels, order, mz_sorted, rt_sorted, n, offsets, mz_flat,
            int_flat, pad_to, linkage, eps, min_matches, fragment_tol,
            precursor_tol_mass, precursor_tol_mode, rt_tol, batch_size,
            hasher, dev)

    def medoid_scores(seg, n_seg):
        """Scores of the rows (numpy, (n,)); ``seg`` puts noise in the
        spill segment ``n_seg - 1``."""
        if unit is None:
            # The lists hold exact similarities: medoids from the same
            # distances the clustering ran on.
            seg_pad = np.full(sims.shape[0], n_seg - 1, np.int32)
            seg_pad[:n] = seg
            scores = medoid_ops.sparse_medoid_scores(
                sims.contiguous(), neigh.contiguous(),
                torch.from_numpy(seg_pad).to(dev), n_seg - 1)
        else:
            # --rerank off clustered on the hashed cosines: medoids from
            # the same vectors.
            scores = medoid_ops.hashed_medoid_scores(
                unit, torch.from_numpy(seg.astype(np.int32)).to(dev),
                n_seg - 1)
        return scores[:n].cpu().numpy()

    return _refine_and_medoids(labels, order, mz_sorted, rt_sorted, n,
                               precursor_tol_mass, precursor_tol_mode,
                               rt_tol, min_samples, medoid_scores)


def scan_width(mz_sorted: np.ndarray, tol_mass: float, tol_mode: str,
               k_final: int, n_neighbors_ann: int) -> int:
    """Candidates per row of the upper-bound scan: the JAX package's
    ``k_ann`` (``n_neighbors_ann``, widened in powers of two for dense
    bands up to its per-pass cap) times its boundary-continued passes,
    with its log lines, at most ``n - 1``."""
    n = len(mz_sorted)
    k_ann = min(max(n_neighbors_ann, k_final), max(n - 1, 1))
    if tol_mode == "Da":
        lo_vals, hi_vals = mz_sorted - tol_mass, mz_sorted + tol_mass
    else:
        lo_vals = mz_sorted / (1 + tol_mass / 1e6)
        hi_vals = mz_sorted / (1 - tol_mass / 1e6)
    spans = (np.searchsorted(mz_sorted, hi_vals, side="right")
             - np.searchsorted(mz_sorted, lo_vals, side="left"))
    span_max = int(spans.max(initial=1)) - 1  # candidates excl. self
    if span_max <= k_ann:
        return k_ann
    # The JAX package caps one pass's (rows, k) lists at 2^28 bytes, a
    # TPU fault limit, and covers the rest of the budget in more passes;
    # the port scans their total at once.
    per_pass = max(min(MAX_NEIGHBORS,
                       2**28 // (8 * _pow2_at_least(n, 512))), k_ann)
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
        k_ann = new_k
    passes = 1
    if span_max > k_ann:
        passes = max(1, -(-min(MAX_NEIGHBORS, span_max, max(n - 1, 1))
                          // k_ann))
    if span_max > k_ann * passes:
        logger.warning(
            "%.1f%% of rows have more in-band candidates (max %d) than the "
            "neighbor budget %d; retrieval may truncate true neighbors in "
            "those bands (raise --n_neighbors_ann)",
            100.0 * float((spans - 1 > k_ann * passes).mean()), span_max,
            k_ann * passes)
    return min(k_ann * passes, max(n - 1, 1))


def compact_candidates(bounds: torch.Tensor, neigh: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """The scan's lists cut to the candidates the rerank must score: ids
    whose bound can reach ``1 - eps`` (the bf16 scan reads a bound at most
    1% low, so the threshold is ``(1 - eps) * 0.99 - 1e-3``, compared in
    float32), the rest -1, in a power-of-two width of at least 16.  The RT
    filter leaves holes in the bound-sorted lists, so the width comes from
    the last surviving column, not the survivor count.  One host sync."""
    keep = bounds >= f32_tolerance((1.0 - eps) * 0.99 - 1e-3)
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
            scan_bf16=True)
        del plain, spread
        synchronize(dev)
    with profiler.phase("ann: rerank"):
        sims, neigh, n_match = rerank_exact(
            mz_pad, int_pad, compact_candidates(sims, neigh, eps),
            fragment_tol, k_final)
        if min_matches > 0:
            sims = torch.where((neigh >= 0) & (n_match < min_matches), 0.0,
                               sims)
        synchronize(dev)
    return sims, neigh


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


def _refine_and_medoids(labels, order, mz_sorted, rt_sorted, n,
                        precursor_tol_mass, precursor_tol_mode, rt_tol,
                        min_samples, medoid_scores_fn):
    """DBSCAN mode's tail: host refinement, medoid selection.

    A copy of the JAX engine's ``_refine_and_medoids`` (whose module
    imports JAX), without its stage timer: the precursor m/z / RT
    refinement of each cluster (clusters inside the span are kept whole or
    demoted below ``max(min_samples, 2)`` members), then per cluster the
    first row with the largest ``medoid_scores_fn(seg, n_seg + 1)`` score,
    noise in the spill segment ``n_seg``."""
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
        for k_i, (start_i, stop_i) in enumerate(slices):
            if sorted_labels[start_i] == -1:
                continue
            if mz_ok[k_i]:
                if stop_i - start_i < min_samples_eff:
                    sorted_labels[start_i:stop_i] = -1
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
