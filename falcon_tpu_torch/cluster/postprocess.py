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

- :func:`link_component` — one group of spectra (an exact-engine interval
  or an eps-component of the ann engine): linkage, the cut at eps, the
  precursor / RT split and the medoids; :func:`link_components` runs it on
  a batch of groups in one native call (``fc_link_components``), or group
  by group where the native library is unavailable
  (``cluster/grouped.py`` calls it for both engines).
"""

from typing import Iterator, Optional, Tuple

import numpy as np

from .. import native
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


def _spans_within(mzs: np.ndarray, rts: Optional[np.ndarray],
                  precursor_tol_mass: float, precursor_tol_mode: str,
                  rt_tol: Optional[float]) -> bool:
    """The precursor (and RT) span of the members is within tolerance."""
    span = float(mzs.max() - mzs.min())
    if precursor_tol_mode == "ppm":
        span_ok = (span / max(float(mzs.min()), 1e-12) * 1e6
                   <= precursor_tol_mass)
    else:
        span_ok = span <= precursor_tol_mass
    if span_ok and rt_tol is not None:
        span_ok = float(rts.max() - rts.min()) <= rt_tol
    return span_ok


def link_component(
    pdist: np.ndarray,
    mzs: np.ndarray,
    rts: Optional[np.ndarray],
    ids: np.ndarray,
    method: str,
    eps: float,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    eps_far: Optional[float] = None,
) -> Tuple[np.ndarray, int, np.ndarray, bool]:
    """One group of spectra (an eps-component, or an exact-engine
    interval) linked, cut at eps, split by precursor (and RT) and given
    its medoids.

    ``pdist``: its condensed float32 distances; ``mzs``, ``rts`` (read
    only with ``rt_tol``) and ``ids`` (dataset row ids): its members in
    the matrix's order.  Returns (each member's label, from 0, -1 for a
    member split off alone; the number of clusters; the medoid ids, noise
    first; whether it closed whole).  It closes whole when no distance is
    above ``eps_far`` and the precursor (and RT) span is within tolerance:
    then the split keeps the one cluster that any linkage cut at eps gives
    when every distance is within eps.  ``eps_far`` defaults to
    ``native.far_threshold(eps)``, eps as NumPy compares a float32
    distance with it (the JAX package's ann engine); the exact engine
    passes eps itself, as the cut compares.
    """
    size = len(ids)
    far = native.far_threshold(eps) if eps_far is None else eps_far
    if not float(pdist.max(initial=0.0)) > far and _spans_within(
            mzs, rts, precursor_tol_mass, precursor_tol_mode, rt_tol):
        labels = np.zeros(size, np.int32)
        med = cluster_medoids(np.asarray(ids, np.int64), labels, pdist,
                              np.arange(size))
        return labels, 1, med, True
    z = native.linkage(pdist, method)
    flat = native.fcluster(z, eps, n=size)
    order1 = np.argsort(flat, kind="stable")
    sorted_labels = flat[order1].astype(np.int32)
    mzs_c = mzs[order1]
    rts_c = rts[order1] if rt_tol is not None else None
    current = 0
    for s_i, e_i in list(cluster_group_slices(sorted_labels)):
        current += postprocess_cluster(
            sorted_labels[s_i:e_i], mzs_c[s_i:e_i],
            rts_c[s_i:e_i] if rts_c is not None else None,
            precursor_tol_mass, precursor_tol_mode, rt_tol, 2, current)
    order2 = np.argsort(sorted_labels, kind="stable")
    med = cluster_medoids(np.asarray(ids, np.int64)[order1[order2]],
                          sorted_labels[order2], pdist, order1[order2])
    labels = np.empty(size, np.int32)
    labels[order1] = sorted_labels
    return labels, current, med, False


def link_components(
    dist: np.ndarray,
    comps: np.ndarray,
    member_off: np.ndarray,
    mzs: np.ndarray,
    rts: Optional[np.ndarray],
    ids: np.ndarray,
    method: str,
    eps: float,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    labels: np.ndarray,
    n_clusters: np.ndarray,
    medoids: np.ndarray,
    n_medoids: np.ndarray,
    eps_far: Optional[float] = None,
) -> int:
    """:func:`link_component` on each component of ``comps``, writing its
    results in place (``native.link_components``' contract): in one native
    call, or one component at a time where the library is unavailable.
    Returns the number of components closed whole."""
    if eps_far is None:
        eps_far = native.far_threshold(eps)
    n_whole = native.link_components(
        dist, comps, member_off, mzs, rts, ids, method, eps,
        precursor_tol_mass, precursor_tol_mode, rt_tol, labels, n_clusters,
        medoids, n_medoids, eps_far)
    if n_whole is not None:
        return n_whole
    n_whole, pair_at = 0, 0
    for c in np.asarray(comps, np.int64).tolist():
        lo, hi = int(member_off[c]), int(member_off[c + 1])
        n_pairs = (hi - lo) * (hi - lo - 1) // 2
        lab, n_cl, med, whole = link_component(
            dist[pair_at:pair_at + n_pairs], mzs[lo:hi],
            rts[lo:hi] if rt_tol is not None else None, ids[lo:hi], method,
            eps, precursor_tol_mass, precursor_tol_mode, rt_tol, eps_far)
        pair_at += n_pairs
        labels[lo:hi] = lab
        n_clusters[c] = n_cl
        medoids[lo:lo + len(med)] = med
        n_medoids[c] = len(med)
        n_whole += whole
    return n_whole
