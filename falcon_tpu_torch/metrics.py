"""Clustering quality metrics.

The driver metric for this framework is "spectra/sec clustered
end-to-end; NN recall@50 and cluster purity vs Faiss ref"
(BASELINE.json), and the north star demands >= 0.99 NN recall@50 vs
exact cosine at matched cluster purity.  This module provides the
first-party implementations used by the bench harness and tests:

- :func:`nn_recall_at_k` — approximate-vs-exact nearest-neighbor recall,
- :func:`cluster_purity` — weighted majority-label purity over clusters
  with >= 2 members (singletons are "unclustered" and excluded, matching
  how MS clustering papers report purity),
- :func:`cluster_completeness` — information-theoretic completeness
  (1 - H(cluster|truth) / H(cluster)), the usual V-measure component,
- :func:`clustered_fraction` — fraction of spectra in non-singleton
  clusters.
"""

from typing import Dict, Tuple

import numpy as np


def nn_recall_at_k(
    approx_idx: np.ndarray,
    exact_idx: np.ndarray,
    k: int,
) -> float:
    """Mean per-query recall@k of approximate vs exact neighbor lists.

    ``approx_idx``/``exact_idx``: (n, >=k) arrays of neighbor ids, -1 for
    missing entries.  For each query, recall = |approx top-k ∩ exact
    top-k| / |exact top-k| (queries whose exact list is empty are
    skipped).
    """
    n = approx_idx.shape[0]
    recalls = []
    for i in range(n):
        exact = exact_idx[i, :k]
        exact = set(exact[exact >= 0].tolist())
        if not exact:
            continue
        approx = approx_idx[i, :k]
        approx = set(approx[approx >= 0].tolist())
        recalls.append(len(exact & approx) / len(exact))
    return float(np.mean(recalls)) if recalls else 1.0


def _cell_counts(
    labels: np.ndarray, truth: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized contingency cells: (label_code per row, truth_code per
    row, per-cell label code, per-cell truth code, per-cell count).

    O(n log n) via joint-code uniquing — the per-class Python loops the
    round-2 implementation used are quadratic at the 25M scale (millions
    of singleton noise classes)."""
    _, label_code = np.unique(labels, return_inverse=True)
    _, truth_code = np.unique(truth, return_inverse=True)
    n_truth = int(truth_code.max(initial=-1)) + 1
    joint = label_code.astype(np.int64) * n_truth + truth_code
    cells, cell_counts = np.unique(joint, return_counts=True)
    return (label_code, truth_code, cells // n_truth, cells % n_truth,
            cell_counts)


def cluster_purity(labels: np.ndarray, truth: np.ndarray) -> float:
    """Weighted majority purity over clusters with >= 2 members.

    purity = sum_c max_t |c ∩ t| / sum_c |c| over non-singleton clusters
    c.  Returns 1.0 when everything is singletons (nothing to get
    wrong).
    """
    labels = np.asarray(labels)
    truth = np.asarray(truth)
    if len(labels) == 0:
        return 1.0
    label_code, _, cell_label, _, counts = _cell_counts(labels, truth)
    label_sizes = np.bincount(label_code)
    keep_cell = label_sizes[cell_label] >= 2
    if not keep_cell.any():
        return 1.0
    cell_label = cell_label[keep_cell]
    counts = counts[keep_cell]
    # max cell count per label: cells are sorted by (label, truth).
    starts = np.flatnonzero(
        np.concatenate([[True], cell_label[1:] != cell_label[:-1]])
    )
    correct = int(np.maximum.reduceat(counts, starts).sum())
    total = int(counts.sum())
    return correct / total


def _entropy(counts: np.ndarray) -> float:
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def cluster_completeness(labels: np.ndarray, truth: np.ndarray) -> float:
    """Completeness: all members of a truth class land in one cluster.

    1 - H(cluster | truth) / H(cluster), the standard V-measure
    component (Rosenberg & Hirschberg 2007); 1.0 when H(cluster) == 0.
    """
    labels = np.asarray(labels)
    truth = np.asarray(truth)
    if len(labels) == 0:
        return 1.0
    label_code, truth_code, _, cell_truth, counts = _cell_counts(
        labels, truth
    )
    label_sizes = np.bincount(label_code)
    h_cluster = _entropy(label_sizes)
    if h_cluster == 0.0:
        return 1.0
    # H(cluster | truth) = -(1/n) * sum_cells n_ct * log(n_ct / n_t)
    n = len(labels)
    truth_sizes = np.bincount(truth_code)
    c = counts.astype(np.float64)
    h_cond = float(-(c * (np.log(c) - np.log(
        truth_sizes[cell_truth].astype(np.float64)
    ))).sum()) / n
    return 1.0 - h_cond / h_cluster


def clustered_fraction(labels: np.ndarray) -> float:
    """Fraction of spectra belonging to clusters with >= 2 members."""
    labels = np.asarray(labels)
    if len(labels) == 0:
        return 0.0
    _, inverse, counts = np.unique(
        labels, return_inverse=True, return_counts=True
    )
    return float((counts[inverse] >= 2).mean())


def pairwise_agreement(
    labels_a: np.ndarray, labels_b: np.ndarray
) -> Dict[str, float]:
    """Pair-counting agreement between two clusterings of the same rows.

    Counts unordered pairs co-clustered by each side: TP = pairs
    co-clustered by both; precision = TP / pairs_a, recall = TP /
    pairs_b, and the F1 of the two.  1.0 iff the partitions agree on
    every co-membership decision (label numbering irrelevant).  Used to
    measure how "label-comparable" the ann and exact backends actually
    are on identical input.
    """
    labels_a = np.asarray(labels_a)
    labels_b = np.asarray(labels_b)

    def n_pairs(counts: np.ndarray) -> int:
        counts = counts.astype(np.int64)
        return int((counts * (counts - 1) // 2).sum())

    _, code_a = np.unique(labels_a, return_inverse=True)
    _, code_b = np.unique(labels_b, return_inverse=True)
    _, counts_a = np.unique(code_a, return_counts=True)
    _, counts_b = np.unique(code_b, return_counts=True)
    # Contingency cell sizes via joint codes.
    joint = code_a.astype(np.int64) * (code_b.max() + 1) + code_b
    _, joint_counts = np.unique(joint, return_counts=True)
    tp = n_pairs(joint_counts)
    pa, pb = n_pairs(counts_a), n_pairs(counts_b)
    precision = tp / pa if pa else 1.0
    recall = tp / pb if pb else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1}


def evaluate_clustering(
    labels: np.ndarray, truth: np.ndarray
) -> Dict[str, float]:
    """Convenience bundle of all clustering metrics."""
    return {
        "purity": cluster_purity(labels, truth),
        "completeness": cluster_completeness(labels, truth),
        "clustered_fraction": clustered_fraction(labels),
    }
