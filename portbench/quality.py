"""Cluster quality against the generator's truth.

Frozen copies of ``falcon_tpu_torch/metrics.py``'s ``cluster_purity`` and
``cluster_completeness`` (the same arithmetic), so that a change to the
program cannot change the yardstick; ``portbench/tests`` holds them equal
to the program's.
"""

from typing import Tuple

import numpy as np


def _cell_counts(labels: np.ndarray, truth: np.ndarray) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(label code per row, truth code per row, per-cell label code,
    per-cell truth code, per-cell count) of the contingency table."""
    _, label_code = np.unique(labels, return_inverse=True)
    _, truth_code = np.unique(truth, return_inverse=True)
    n_truth = int(truth_code.max(initial=-1)) + 1
    joint = label_code.astype(np.int64) * n_truth + truth_code
    cells, cell_counts = np.unique(joint, return_counts=True)
    return (label_code, truth_code, cells // n_truth, cells % n_truth,
            cell_counts)


def cluster_purity(labels: np.ndarray, truth: np.ndarray) -> float:
    """Weighted majority purity over clusters of two or more members; 1.0
    when every cluster is a singleton."""
    labels, truth = np.asarray(labels), np.asarray(truth)
    if len(labels) == 0:
        return 1.0
    label_code, _, cell_label, _, counts = _cell_counts(labels, truth)
    label_sizes = np.bincount(label_code)
    keep = label_sizes[cell_label] >= 2
    if not keep.any():
        return 1.0
    cell_label, counts = cell_label[keep], counts[keep]
    starts = np.flatnonzero(
        np.concatenate([[True], cell_label[1:] != cell_label[:-1]]))
    return int(np.maximum.reduceat(counts, starts).sum()) / int(counts.sum())


def _entropy(counts: np.ndarray) -> float:
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def cluster_completeness(labels: np.ndarray, truth: np.ndarray) -> float:
    """1 - H(cluster | truth) / H(cluster) (Rosenberg and Hirschberg,
    2007); 1.0 when H(cluster) is 0."""
    labels, truth = np.asarray(labels), np.asarray(truth)
    if len(labels) == 0:
        return 1.0
    label_code, truth_code, _, cell_truth, counts = _cell_counts(labels,
                                                                 truth)
    h_cluster = _entropy(np.bincount(label_code))
    if h_cluster == 0.0:
        return 1.0
    truth_sizes = np.bincount(truth_code)
    c = counts.astype(np.float64)
    h_cond = float(-(c * (np.log(c) - np.log(
        truth_sizes[cell_truth].astype(np.float64)))).sum()) / len(labels)
    return 1.0 - h_cond / h_cluster
