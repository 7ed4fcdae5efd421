"""The frozen metric copies against the port's."""

import numpy as np
import pytest

from falcon_tpu_torch import metrics
from portbench import quality


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_copies_agree(seed):
    rng = np.random.default_rng(seed)
    n = 500
    truth = rng.integers(0, 60, n)
    labels = np.where(rng.random(n) < 0.8, truth,
                      rng.integers(0, 200, n)) * 7 + 3
    for fn in ("cluster_purity", "cluster_completeness"):
        assert getattr(quality, fn)(labels, truth) == getattr(
            metrics, fn)(labels, truth)


def test_edge_cases_agree():
    for labels, truth in ((np.array([], np.int64), np.array([], np.int64)),
                          (np.arange(5), np.zeros(5, np.int64)),
                          (np.zeros(5, np.int64), np.arange(5))):
        assert quality.cluster_purity(labels, truth) == \
            metrics.cluster_purity(labels, truth)
        assert quality.cluster_completeness(labels, truth) == \
            metrics.cluster_completeness(labels, truth)
