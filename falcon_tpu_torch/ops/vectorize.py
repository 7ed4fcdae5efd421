"""Spectrum binning + feature hashing into dense vectors, in PyTorch.

Port of ``falcon_tpu/ops/vectorize.py::SpectrumHasher``: each peak falls in
bin ``floor((mz - min_bound) / bin_size)`` (float32, as on the TPU), every
bin maps to one of ``low_dim`` dimensions through the MurmurHash3
table (``ops/hashing.py``, a copy of the JAX package's), and intensities that land on the same
dimension add up.  ``spread=True`` also adds each peak into its two
neighbouring bins before hashing, which with unnormalised vectors makes
``spread_a . plain_b`` a strict upper bound on the exact matched-peak
score (the argument is in the JAX module's docstring).

The scatter is ``index_add_`` over the flattened ``(n, dim_padded)``
output, in the JAX package's order (all peaks of shift -1, then 0, then
+1).  On the CPU the sums come out in that order; on CUDA ``index_add_``
is atomic, so a vector can differ from run to run by float32 rounding.
The one consumer on the port's path, the pruned linkage bound
(``ops/pairwise.py``), carries a 1e-3 slack that absorbs that.
"""

import numpy as np
import torch

from .hashing import binning_dims, hash_bin_mapping


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SpectrumHasher:
    """Binning + hashing configuration; the bin -> dimension table is
    built once on the host and copied to each device on first use."""

    def __init__(self, min_mz: float, max_mz: float, bin_size: float,
                 low_dim: int = 400, seed: int = 0):
        self.n_bins, self.min_bound, self.max_bound = binning_dims(
            min_mz, max_mz, bin_size)
        self.bin_size = float(bin_size)
        self.low_dim = int(low_dim)
        self.dim_padded = round_up(low_dim, 128)
        self.seed = int(seed)
        self.mapping = hash_bin_mapping(self.n_bins, low_dim, seed)
        self._mapping_on = {}

    def _mapping(self, device: torch.device) -> torch.Tensor:
        if device not in self._mapping_on:
            self._mapping_on[device] = torch.from_numpy(
                self.mapping.astype(np.int64)).to(device)
        return self._mapping_on[device]

    def vectorize(self, mz: torch.Tensor, intensity: torch.Tensor,
                  norm: bool = True, spread: bool = False) -> torch.Tensor:
        """Padded (n, P) float32 peaks -> (n, dim_padded) float32 vectors
        on the same device.  Padding peaks (intensity 0) and peaks outside
        the binning range add nothing."""
        n, p = mz.shape
        mapping = self._mapping(mz.device)
        bin_idx = torch.floor(
            (mz - np.float32(self.min_bound)) / np.float32(self.bin_size)
        ).to(torch.int64)
        row_base = (torch.arange(n, device=mz.device)
                    * self.dim_padded)[:, None]
        flat = torch.zeros(n * self.dim_padded, dtype=torch.float32,
                           device=mz.device)
        for shift in ((-1, 0, 1) if spread else (0,)):
            b = bin_idx + shift
            in_range = (b >= 0) & (b < self.n_bins) & (intensity > 0)
            weights = torch.where(in_range, intensity, 0.0)
            dims = mapping[b.clamp(0, self.n_bins - 1)]
            flat.index_add_(0, (row_base + dims).reshape(-1),
                            weights.reshape(-1))
        vectors = flat.view(n, self.dim_padded)
        if norm:
            norms = torch.linalg.vector_norm(vectors, dim=1, keepdim=True)
            vectors = vectors / norms.clamp_min(1e-12)
        return vectors
