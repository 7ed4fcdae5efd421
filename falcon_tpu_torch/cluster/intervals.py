"""Precursor m/z interval splitting and 1-D tolerance cuts.

Vectorized NumPy replacements for the reference's njit helpers:

- :func:`precursor_mz_splits` — reference ``_get_precursor_mz_splits``
  (``falcon/cluster/cluster.py:159-209``): contiguous blocks of sorted
  precursor m/z separated by gaps larger than the precursor tolerance,
  with oversized blocks evenly chunked to at most ``batch_size``.
  Divergence (documented): the reference never chunks the trailing block
  (the chunking only runs when a gap is found mid-array,
  ``cluster.py:186-206``), so a gap-free dataset would produce one
  unbounded block; we chunk the trailing block by the same even rule.

- :func:`cut_1d` — the composition ``fcluster(_linkage(values, tol_mode),
  tol, "distance")`` from the reference's cluster post-splitting
  (``falcon/cluster/cluster.py:412-421, 458-509``).  The reference builds
  a full 1-D complete-linkage dendrogram; since only merges at distance
  <= tol affect the cut, we simulate exactly those merges with a priority
  queue in O(k log k) instead of O(k^2).  Adjacent-cluster distance is
  ``right.max - left.min`` (i.e. the span of the union), converted to ppm
  relative to ``left.min`` when ``tol_mode == 'ppm'``
  (``cluster.py:479-483``).
"""

import heapq
from typing import Optional

import numpy as np


def mass_diff(mz1, mz2, mode_is_da: bool):
    """spectrum_utils ``mass_diff`` (used at reference
    ``cluster.py:191-196``)."""
    return mz1 - mz2 if mode_is_da else (mz1 - mz2) / mz2 * 10**6


def precursor_mz_splits(
    precursor_mzs: np.ndarray,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    batch_size: int,
) -> np.ndarray:
    """Split indices for contiguous precursor-m/z blocks (sorted input)."""
    n = len(precursor_mzs)
    if n == 0:
        return np.array([0, 0], np.int64)
    diffs = mass_diff(
        precursor_mzs[1:], precursor_mzs[:-1],
        precursor_tol_mode == "Da",
    )
    gap_idx = np.flatnonzero(diffs > precursor_tol_mass) + 1
    splits = [0]
    for boundary in list(gap_idx) + [n]:
        block_size = boundary - splits[-1]
        if block_size <= 0:
            continue
        if block_size < batch_size:
            splits.append(int(boundary))
        else:
            n_chunks = -(-block_size // batch_size)
            chunk_size = block_size // n_chunks
            for _ in range(block_size % n_chunks):
                splits.append(splits[-1] + chunk_size + 1)
            for _ in range(n_chunks - (block_size % n_chunks)):
                splits.append(splits[-1] + chunk_size)
    return np.asarray(splits, np.int64)


def cut_1d(
    values: np.ndarray, tol: float, tol_mode: Optional[str] = None
) -> np.ndarray:
    """Flat clusters of 1-D values, complete-linkage cut at ``tol``.

    Equivalent to the reference's ``fcluster(_linkage(values, tol_mode),
    tol, "distance") - 1`` up to label numbering (labels here are numbered
    by first occurrence in the input order; callers renumber anyway,
    cf. ``_postprocess_cluster`` reference ``cluster.py:431-453``).
    """
    k = len(values)
    if k == 0:
        return np.zeros(0, np.int32)
    if k == 1:
        return np.zeros(1, np.int32)
    order = np.argsort(values, kind="stable")
    sorted_vals = np.asarray(values, np.float64)[order]

    # Disjoint-set over sorted positions; each cluster tracks (min, max),
    # its current left/right neighbor cluster, and a version counter so
    # heap entries computed from an outdated extent are recognized as
    # stale (a cluster's span only grows, so a stale entry always carries
    # a too-small distance and must not be honored).
    parent = np.arange(k)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cmin = sorted_vals.copy()
    cmax = sorted_vals.copy()
    version = np.zeros(k, np.int64)
    left = np.arange(k) - 1   # neighbor root to the left (-1 = none)
    right = np.arange(k) + 1  # neighbor root to the right (k = none)

    def dist(a, b):
        """Merge distance between adjacent clusters a (left) and b."""
        d = cmax[b] - cmin[a]
        if tol_mode == "ppm":
            d = d / cmin[a] * 10**6
        return d

    heap = [(dist(i, i + 1), i, i + 1, 0, 0) for i in range(k - 1)]
    heapq.heapify(heap)
    while heap:
        d, a, b, va, vb = heapq.heappop(heap)
        if d > tol:
            break
        # Stale if either endpoint is no longer a root, was mutated since
        # this entry was pushed, or is no longer adjacent.
        if (find(a) != a or find(b) != b or right[a] != b
                or version[a] != va or version[b] != vb):
            continue
        # Merge b into a.
        parent[b] = a
        cmax[a] = max(cmax[a], cmax[b])
        cmin[a] = min(cmin[a], cmin[b])
        version[a] += 1
        r = right[b]
        right[a] = r
        if r < k:
            left[r] = a
            heapq.heappush(
                heap, (dist(a, r), a, r, version[a], version[r])
            )
        lft = left[a]
        if lft >= 0 and find(lft) == lft:
            heapq.heappush(
                heap, (dist(lft, a), lft, a, version[lft], version[a])
            )

    # Labels by first occurrence in the original input order.
    roots_sorted = np.array([find(i) for i in range(k)])
    labels_by_pos = np.empty(k, np.int64)
    labels_by_pos[order] = roots_sorted
    _, first_idx, inverse = np.unique(
        labels_by_pos, return_index=True, return_inverse=True
    )
    # Renumber so that label ids follow first occurrence in input order.
    remap = np.empty(len(first_idx), np.int32)
    remap[np.argsort(first_idx, kind="stable")] = np.arange(
        len(first_idx), dtype=np.int32
    )
    return remap[inverse].astype(np.int32)
