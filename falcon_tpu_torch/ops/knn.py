"""Precursor-band geometry and the top-k merge shared by the port's k-NN.

Port of the JAX-free pieces of ``falcon_tpu/ops/knn.py`` that the exact
index (``ops/exact_knn.py``) needs: the ``NEG`` sentinel, the power-of-two
bucketing rule, ``band_bounds`` (a NumPy copy: the JAX module imports JAX
when it is imported) and ``merge_topk``.

Top-k order is the JAX package's: score descending, ties to the lower
position.  ``torch.topk`` promises no order for ties on CUDA, so every
top-k of the port is a stable descending sort (``stable_topk``).
"""

from typing import Tuple

import numpy as np
import torch

NEG = -2.0  # below any cosine similarity


def _pow2_at_least(x: int, minimum: int = 512) -> int:
    size = minimum
    while size < x:
        size *= 2
    return size


def band_bounds(mzs: np.ndarray, tol_mass: float, tol_is_da: bool):
    """Per-row tolerance-band bounds (inclusive lo, exclusive hi) of
    SORTED precursor m/z, covering the device's float32 acceptance test.

    The bounds come from the float32 m/z the device compares, widened by
    a few float32 ULPs, so a window never excludes a boundary pair that
    the float32 test accepts (``falcon_tpu/ops/knn.py::band_bounds``).
    """
    mzs32 = np.asarray(mzs, np.float64).astype(np.float32).astype(
        np.float64)
    ulp = 4e-7  # ~3.4 float32 ULPs of relative slack
    if tol_is_da:
        slack = ulp * np.abs(mzs32)
        lo_vals = mzs32 - tol_mass - slack
        hi_vals = mzs32 + tol_mass + slack
    else:
        # The test accepts |q-c|/c*1e6 <= tol, i.e. candidates up to
        # q/(1-tol/1e6) (> q*(1+tol/1e6) by ~q*tol^2).
        lo_vals = mzs32 / (1 + tol_mass / 1e6) * (1 - ulp)
        hi_vals = mzs32 / (1 - tol_mass / 1e6) * (1 + ulp)
    return (np.searchsorted(mzs32, lo_vals, side="left"),
            np.searchsorted(mzs32, hi_vals, side="right"))


def stable_topk(values: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their positions, as
    ``lax.top_k`` orders them: descending, ties to the lower position."""
    top, pos = torch.sort(values, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]


def merge_topk(s1: torch.Tensor, i1: torch.Tensor, s2: torch.Tensor,
               i2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (rows, k') top-k result pairs into the best ``k``; on a
    tie the first pair's entry wins."""
    top, pos = stable_topk(torch.cat([s1, s2], dim=1), k)
    return top, torch.gather(torch.cat([i1, i2], dim=1), 1, pos)
