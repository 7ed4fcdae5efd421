"""Spectrum binning + feature hashing into dense vectors: a CUDA kernel and
its plain version.

Port of ``falcon_tpu/ops/vectorize.py::SpectrumHasher``: each peak falls in
bin ``floor((mz - min_bound) / bin_size)`` (float32, as on the TPU), every
bin maps to one of ``low_dim`` dimensions through the MurmurHash3 table
(``ops/hashing.py``, a copy of the JAX package's), and intensities that
land on the same dimension add up.  ``spread=True`` also adds each peak into its two
neighbouring bins before hashing, which with unnormalised vectors makes
``spread_a . plain_b`` a strict upper bound on the exact matched-peak
score (the argument is in the JAX module's docstring).

``vectorize`` replaces the JAX package's XLA scatter-adds (``vectorize_body``
and ``_vectorize_spread``) with a kernel (``csrc/vectorize.cu``, one warp per
spectrum) for CUDA tensors and runs ``vectorize_plain`` for CPU tensors.
Both add each dimension's hits in one fixed order (shift -1, 0, +1, each in
peak order) and sum the norm's squares in the same halving tree, so they
agree bit for bit and a run on the card is repeatable; an atomic scatter
(``index_add_`` on CUDA) adds in no fixed order.  The upper-bound scan
ranks candidates by these vectors, so a last-bit change there could reorder
near-ties.
"""

import numpy as np
import torch

from . import _build
from .hashing import binning_dims, hash_bin_mapping
from .matching import _tree_sum
from .pairwise import _check_launch, _check_spectra, count_launch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_mapping(mapping: torch.Tensor, n_bins: int, dim_padded: int,
                   device: torch.device) -> None:
    if (mapping.dtype != torch.int64 or mapping.shape != (n_bins,)
            or mapping.device != device or not mapping.is_contiguous()):
        raise ValueError(f"vectorize: mapping must be a contiguous int64 "
                         f"tensor of {n_bins} dimensions on {device}")
    if dim_padded <= 0 or dim_padded % 128:
        raise ValueError(f"vectorize: dim_padded must be a positive "
                         f"multiple of 128, got {dim_padded}")


def vectorize(mz: torch.Tensor, intensity: torch.Tensor,
              mapping: torch.Tensor, min_bound: float, bin_size: float,
              n_bins: int, dim_padded: int, norm: bool = True,
              spread: bool = False) -> torch.Tensor:
    """Padded (n, P) float32 peaks -> (n, dim_padded) float32 vectors on
    the same device (the kernel on CUDA, where P must be 64).  Padding
    peaks (intensity 0) and peaks outside the binning range add
    nothing."""
    device = _check_spectra("vectorize", mz, intensity)
    if mz.shape != intensity.shape:
        raise ValueError("vectorize: m/z and intensity shapes differ")
    _check_mapping(mapping, n_bins, dim_padded, device)
    if device.type == "cpu":
        return vectorize_plain(mz, intensity, mapping, min_bound, bin_size,
                               n_bins, dim_padded, norm, spread)
    lib = _build.library()
    out = torch.empty((mz.shape[0], dim_padded), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        err = lib.falcon_vectorize(
            mz.data_ptr(), intensity.data_ptr(), mz.shape[0],
            mapping.data_ptr(), int(n_bins), float(np.float32(min_bound)),
            float(np.float32(bin_size)), int(dim_padded), int(bool(spread)),
            int(bool(norm)), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check_launch("vectorize", err)
    count_launch(vectorize)
    return out


vectorize.launches = 0


def vectorize_plain(mz: torch.Tensor, intensity: torch.Tensor,
                    mapping: torch.Tensor, min_bound: float, bin_size: float,
                    n_bins: int, dim_padded: int, norm: bool = True,
                    spread: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`vectorize` (any device): one
    scatter per (shift, peak column), each touching one entry per row, so
    the sums come out in the kernel's order on any device."""
    n, p = mz.shape
    # The bin size as a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can move a peak to the next bin.
    size = torch.tensor(bin_size, dtype=torch.float32, device=mz.device)
    bin_idx = torch.floor((mz - np.float32(min_bound)) / size).to(
        torch.int64)
    vectors = torch.zeros((n, dim_padded), dtype=torch.float32,
                          device=mz.device)
    for shift in ((-1, 0, 1) if spread else (0,)):
        b = bin_idx + shift
        in_range = (b >= 0) & (b < n_bins) & (intensity > 0)
        weights = torch.where(in_range, intensity, 0.0)
        dims = mapping[b.clamp(0, n_bins - 1)]
        for j in range(p):
            vectors.scatter_add_(1, dims[:, j:j + 1], weights[:, j:j + 1])
    if norm:
        # The square root of a float32 taken in float64 and rounded is the
        # correctly rounded float32 one (the kernel's __fsqrt_rn); the
        # CPU's vectorised float32 sqrt may be an ulp off.
        norms = torch.sqrt(_tree_sum(vectors * vectors).double()).float()
        vectors = vectors / norms[:, None].clamp_min(1e-12)
    return vectors


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
        on the same device, through the module-level :func:`vectorize`
        (looked up at call time, so a caller may swap in the plain
        version)."""
        return vectorize(mz, intensity, self._mapping(mz.device),
                         self.min_bound, self.bin_size, self.n_bins,
                         self.dim_padded, norm, spread)
