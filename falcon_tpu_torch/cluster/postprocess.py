"""Cluster refinement, medoids, and global label assignment.

NumPy implementations of the reference's njit post-clustering helpers with
identical observable semantics:

- :func:`postprocess_cluster` — reference ``_postprocess_cluster``
  (``falcon/cluster/cluster.py:362-455``): split each initial cluster so
  precursor m/z (and optionally RT) stay within tolerance, demote
  sub-``min_samples`` groups to noise (-1), relabel surviving groups
  ``start_label..`` in first-occurrence order.
  Divergence (documented, SURVEY.md §3.5): when both m/z and RT splits
  apply, the reference combines them as ``mz_label*2 + rt_label*3``
  (labeled "prime factorization", but not injective — distinct (mz, rt)
  combinations can collide and merge, ``cluster.py:423-429``); we use a
  true pairing (``mz_label * (max_rt + 1) + rt_label``).

- :func:`cluster_medoids` — reference ``_get_cluster_medoids``
  (``cluster.py:512-553``): per cluster, the member minimizing the sum of
  within-cluster pairwise distances (first minimum wins); noise points
  are their own representatives.

- :func:`assign_global_cluster_labels` — reference
  ``_assign_global_cluster_labels`` (``cluster.py:556-590``).
"""

from typing import Iterator, Optional, Tuple

import numpy as np

from .intervals import cut_1d


def cluster_group_slices(sorted_labels: np.ndarray) -> Iterator[
        Tuple[int, int]]:
    """(start, stop) slices of identical labels in a label-sorted array,
    with each leading noise (-1) point yielded as its own singleton
    (reference ``_get_cluster_group_idx``, ``cluster.py:334-359``)."""
    n = len(sorted_labels)
    start_i = 0
    while start_i < n and sorted_labels[start_i] == -1:
        yield start_i, start_i + 1
        start_i += 1
    stop_i = start_i
    while stop_i < n:
        start_i, label = stop_i, sorted_labels[stop_i]
        while stop_i < n and sorted_labels[stop_i] == label:
            stop_i += 1
        yield start_i, stop_i


def postprocess_cluster(
    cluster_labels: np.ndarray,
    cluster_mzs: np.ndarray,
    cluster_rts: np.ndarray,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    min_samples: int,
    start_label: int,
) -> int:
    """Refine one initial cluster in place; returns #resulting clusters."""
    if cluster_labels.shape[0] < min_samples:
        cluster_labels.fill(-1)
        return 0
    # Fast path for the common tight cluster: when the precursor span
    # (and RT span) is within tolerance, the 1-D linkage cut cannot
    # split (its root merge distance IS the span), so the group
    # machinery below is skipped entirely — the dominant host cost of
    # refinement at scale (profiled: ~half the ann linkage stage).
    mz_lo = float(cluster_mzs.min())
    mz_span = float(cluster_mzs.max()) - mz_lo
    if precursor_tol_mode == "ppm":
        span_ok = (mz_span / max(mz_lo, 1e-12) * 1e6
                   <= precursor_tol_mass)
    else:
        span_ok = mz_span <= precursor_tol_mass
    if span_ok and rt_tol is not None:
        span_ok = (float(cluster_rts.max()) - float(cluster_rts.min())
                   <= rt_tol)
    if span_ok:
        cluster_labels.fill(start_label)
        return 1
    assignments = cut_1d(
        cluster_mzs, precursor_tol_mass, precursor_tol_mode
    ).astype(np.int64)
    if rt_tol is not None:
        rt_assignments = cut_1d(cluster_rts, rt_tol, None).astype(np.int64)
        # True pairing (divergence from reference's mz*2 + rt*3; see
        # module docstring).
        combined = assignments * (rt_assignments.max() + 1) + rt_assignments
        assignments = np.unique(combined, return_inverse=True)[1]

    n_groups = int(assignments.max()) + 1
    if n_groups == 1:
        cluster_labels.fill(start_label)
        return 1
    if n_groups == cluster_mzs.shape[0]:
        cluster_labels.fill(-1)
        return 0
    # Count per group; relabel groups with >= min_samples members in
    # first-occurrence order (reference cluster.py:431-453 iterates an
    # insertion-ordered dict).
    uniq, first_idx, inverse, counts = np.unique(
        assignments, return_index=True, return_inverse=True,
        return_counts=True,
    )
    order = np.argsort(first_idx, kind="stable")
    remap = np.full(len(uniq), -1, np.int64)
    next_label = start_label
    for u in order:
        if counts[u] >= min_samples:
            remap[u] = next_label
            next_label += 1
    cluster_labels[:] = remap[inverse]
    return int(next_label - start_label)


def condensed_index(i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    """Index into a condensed distance matrix for i < j (reference
    ``condensed_index``, ``cluster.py:642-665``)."""
    return (n * i + j - ((i + 2) * (i + 1)) // 2).astype(np.int64)


_TRIU_CACHE: dict = {}


def _triu_cached(size: int):
    """np.triu_indices(size, 1), memoized: rebuilding it per tiny group
    dominated medoid selection at scale (profiled)."""
    cached = _TRIU_CACHE.get(size)
    if cached is None and size <= 512:
        cached = _TRIU_CACHE[size] = np.triu_indices(size, k=1)
    return cached if cached is not None else np.triu_indices(size, k=1)


def cluster_medoids(
    idx_interval: np.ndarray,
    sorted_labels: np.ndarray,
    pdist: np.ndarray,
    order_map: np.ndarray,
) -> np.ndarray:
    """Medoid (dataset row index) per group in label-sorted order.

    ``order_map`` maps label-sorted positions to pairwise-matrix row
    indices (reference ``cluster.py:512-553``).  Noise singletons are
    their own medoids.
    """
    n = len(idx_interval)
    medoids = []
    for start_i, stop_i in cluster_group_slices(sorted_labels):
        size = stop_i - start_i
        if size == 2:
            # Both members share the same row sum (the one pairwise
            # distance): first minimum wins.
            medoids.append(idx_interval[start_i])
        elif size > 1:
            rows = order_map[start_i:stop_i].astype(np.int64)
            ii, jj = _triu_cached(size)
            a, b = rows[ii], rows[jj]
            swap = a > b
            a2 = np.where(swap, b, a)
            b2 = np.where(swap, a, b)
            d = pdist[condensed_index(a2, b2, n)]
            row_sum = np.zeros(size, np.float32)
            np.add.at(row_sum, ii, d)
            np.add.at(row_sum, jj, d)
            medoids.append(idx_interval[start_i + int(np.argmin(row_sum))])
        else:
            medoids.append(idx_interval[start_i])
    return np.asarray(medoids, np.int64)


def assign_global_cluster_labels(
    cluster_labels: np.ndarray,
    idx: np.ndarray,
    splits: np.ndarray,
    current_label: int,
) -> int:
    """Offset per-split labels so they are globally unique; returns the
    maximum assigned label (reference ``cluster.py:556-590``)."""
    max_label = current_label
    for i in range(len(splits) - 1):
        rows = idx[splits[i]:splits[i + 1]]
        mask = cluster_labels[rows] != -1
        if mask.any():
            sel = rows[mask]
            cluster_labels[sel] += current_label
            max_label = max(max_label, int(cluster_labels[sel].max()))
        # The reference advances the offset after every split, clustered
        # or not (cluster.py:586-589), so we do too.
        current_label = max_label + 1
    return max_label
