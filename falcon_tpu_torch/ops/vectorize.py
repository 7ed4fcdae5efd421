"""Spectrum binning + feature hashing into dense vectors: a CUDA kernel and
its plain version.

Port of ``falcon_tpu/ops/vectorize.py::SpectrumHasher``: each peak falls in
bin ``floor((mz - min_bound) * (1 / bin_size))`` in float32 (XLA turns the
JAX package's division by the constant bin size into a product with its
float32 reciprocal, so the port bins the same way), every
bin maps to one of ``low_dim`` dimensions through the MurmurHash3 table
(``ops/hashing.py``, a copy of the JAX package's), and intensities that
land on the same dimension add up.  ``spread=True`` also adds each peak into its two
neighbouring bins before hashing, which with unnormalised vectors makes
``spread_a . plain_b`` a strict upper bound on the exact matched-peak
score (the argument is in the JAX module's docstring).

``vectorize`` replaces the JAX package's XLA scatter-adds (``vectorize_body``
and ``_vectorize_spread``) with a kernel (``csrc/vectorize.cu``, one warp per
spectrum) for CUDA tensors and runs ``vectorize_plain`` for CPU tensors;
``vectorize_pair`` writes the plain and the spread vectors of the same
peaks from one read of them (the default ann path's two sets).
Both add each dimension's hits in one fixed order (shift -1, 0, +1, each in
peak order) and sum the norm's squares in the same halving tree, so they
agree bit for bit and a run on the card is repeatable; an atomic scatter
(``index_add_`` on CUDA) adds in no fixed order.  The upper-bound scan
ranks candidates by these vectors, so a last-bit change there could reorder
near-ties.
"""

import threading
from typing import Tuple

import numpy as np
import torch

from ..device import synchronize
from . import _build
from .hashing import binning_dims, hash_bin_mapping
from .matching import _tree_sum
from .pairwise import _check_launch, _check_spectra, count_launch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def inverse_bin(bin_size: float) -> np.float32:
    """The float32 reciprocal of the float32 bin size, which XLA multiplies
    by where the JAX package divides by the constant."""
    return np.float32(1.0) / np.float32(bin_size)


def normalize_rows(vectors: torch.Tensor) -> torch.Tensor:
    """``v / max(||v||, 1e-12)`` per row in the JAX package's order
    (``falcon_tpu/cluster/ann_engine.py::_normalize_rows`` on XLA's CPU):
    the squares, each rounded, summed in order within windows of 32
    dimensions (the padding split evenly before and after), then the
    windows' sums in order; the root correctly rounded.  Bit for bit the
    JAX package's unit vectors, which ``--rerank off`` clusters and picks
    medoids on (two-member clusters tie there up to the last bit).  Plain
    PyTorch (any device): no scatter, a fixed order."""
    n, dim = vectors.shape
    sq = vectors * vectors
    if dim > 32:
        n_win = -(-dim // 32)
        low = (n_win * 32 - dim) // 2
        sq = torch.nn.functional.pad(sq, (low, n_win * 32 - dim - low))
        sq = sq.view(n, n_win, 32)
        parts = torch.zeros((n, n_win), dtype=torch.float32,
                            device=vectors.device)
        for j in range(32):
            parts = parts + sq[:, :, j]
        sq = parts
    total = torch.zeros(n, dtype=torch.float32, device=vectors.device)
    for j in range(sq.shape[1]):
        total = total + sq[:, j]
    norms = torch.sqrt(total.double()).float()
    return vectors / norms[:, None].clamp_min(1e-12)


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
    device = _check_inputs(mz, intensity, mapping, n_bins, dim_padded)
    if device.type == "cpu":
        return vectorize_plain(mz, intensity, mapping, min_bound, bin_size,
                               n_bins, dim_padded, norm, spread)
    out = torch.empty((mz.shape[0], dim_padded), dtype=torch.float32,
                      device=device)
    _launch(mz, intensity, mapping, min_bound, bin_size, n_bins, dim_padded,
            norm, None if spread else out, out if spread else None)
    count_launch(vectorize)
    return out


vectorize.launches = 0


def vectorize_pair(mz: torch.Tensor, intensity: torch.Tensor,
                   mapping: torch.Tensor, min_bound: float, bin_size: float,
                   n_bins: int, dim_padded: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(plain, spread) unnormalised vectors of the same peaks, equal to
    ``vectorize(..., norm=False)`` and ``vectorize(..., norm=False,
    spread=True)``; on CUDA one launch reads the peaks once and writes
    both."""
    device = _check_inputs(mz, intensity, mapping, n_bins, dim_padded)
    if device.type == "cpu":
        return vectorize_pair_plain(mz, intensity, mapping, min_bound,
                                    bin_size, n_bins, dim_padded)
    plain, spread = (torch.empty((mz.shape[0], dim_padded),
                                 dtype=torch.float32, device=device)
                     for _ in range(2))
    _launch(mz, intensity, mapping, min_bound, bin_size, n_bins, dim_padded,
            False, plain, spread)
    count_launch(vectorize_pair)
    return plain, spread


vectorize_pair.launches = 0


def _check_inputs(mz, intensity, mapping, n_bins, dim_padded):
    device = _check_spectra("vectorize", mz, intensity)
    if mz.shape != intensity.shape:
        raise ValueError("vectorize: m/z and intensity shapes differ")
    _check_mapping(mapping, n_bins, dim_padded, device)
    return device


def _launch(mz, intensity, mapping, min_bound, bin_size, n_bins, dim_padded,
            norm, out_plain, out_spread) -> None:
    lib = _build.library()
    with torch.cuda.device(mz.device):
        err = lib.falcon_vectorize(
            mz.data_ptr(), intensity.data_ptr(), mz.shape[0],
            mapping.data_ptr(), int(n_bins), float(np.float32(min_bound)),
            float(inverse_bin(bin_size)), int(dim_padded), int(bool(norm)),
            None if out_plain is None else out_plain.data_ptr(),
            None if out_spread is None else out_spread.data_ptr(),
            torch.cuda.current_stream(mz.device).cuda_stream,
        )
    _check_launch("vectorize", err)


def vectorize_pair_plain(mz: torch.Tensor, intensity: torch.Tensor,
                         mapping: torch.Tensor, min_bound: float,
                         bin_size: float, n_bins: int, dim_padded: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`vectorize_pair` (any device)."""
    args = (mz, intensity, mapping, min_bound, bin_size, n_bins, dim_padded,
            False)
    return vectorize_plain(*args), vectorize_plain(*args, spread=True)


def vectorize_plain(mz: torch.Tensor, intensity: torch.Tensor,
                    mapping: torch.Tensor, min_bound: float, bin_size: float,
                    n_bins: int, dim_padded: int, norm: bool = True,
                    spread: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`vectorize` (any device): one
    scatter per (shift, peak column), each touching one entry per row, so
    the sums come out in the kernel's order on any device."""
    n, p = mz.shape
    # A float32 product with the float32 reciprocal, as a tensor (PyTorch's
    # CUDA arithmetic with a Python scalar rounds the scalar otherwise).
    scale = torch.tensor(inverse_bin(bin_size), device=mz.device)
    bin_idx = torch.floor((mz - np.float32(min_bound)) * scale).to(
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
    built once on the host and copied to each device on first use (under
    a lock, and waited for, since block workers on other streams read
    it)."""

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
        self._lock = threading.Lock()

    def _mapping(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            if device not in self._mapping_on:
                table = torch.from_numpy(self.mapping.astype(np.int64)).to(
                    device)
                synchronize(device)
                self._mapping_on[device] = table
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

    def vectorize_pair(self, mz: torch.Tensor, intensity: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(plain, spread) unnormalised vectors through the module-level
        :func:`vectorize_pair` (looked up at call time)."""
        return vectorize_pair(mz, intensity, self._mapping(mz.device),
                              self.min_bound, self.bin_size, self.n_bins,
                              self.dim_padded)
