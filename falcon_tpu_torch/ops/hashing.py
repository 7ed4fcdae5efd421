"""MurmurHash3-based feature hashing for spectrum vectorization.

The published falcon algorithm (reference ``README.md:119-146``) converts
binned sparse spectrum vectors to low-dimensional dense vectors by hashing
each m/z bin index to an output dimension with MurmurHash3.  The snapshot
only retains this as dead code (``falcon/cluster/spectrum.py:202-296``,
where the hashing matrix is the caller-supplied ``transformation``); here
it is a first-party, fully vectorized implementation.

``murmurhash3_32`` is the reference x86 32-bit MurmurHash3 over the
4-byte little-endian encoding of the bin index.  The bin->dimension map is
precomputed once per (mz range, bin size, low_dim, seed) and applied on
device as a gather + segment-sum.
"""

from typing import Tuple

import numpy as np


def murmurhash3_32(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized MurmurHash3 x86 32-bit of int32/uint32 keys.

    Equivalent to hashing each key's 4-byte little-endian representation.
    """
    keys = np.asarray(keys).astype(np.uint32)
    seed = np.uint32(seed)
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    with np.errstate(over="ignore"):
        k = keys * c1
        k = rotl(k, 15)
        k = k * c2
        h = np.full_like(keys, seed) ^ k
        h = rotl(h, 13)
        h = h * np.uint32(5) + np.uint32(0xE6546B64)
        # Finalization (length = 4 bytes).
        h ^= np.uint32(4)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def hash_bin_mapping(
    n_bins: int, low_dim: int, seed: int = 0
) -> np.ndarray:
    """bin index -> hashed output dimension, int32 (n_bins,)."""
    return (
        murmurhash3_32(np.arange(n_bins), seed) % np.uint32(low_dim)
    ).astype(np.int32)


def binning_dims(
    min_mz: float, max_mz: float, bin_size: float
) -> Tuple[int, float, float]:
    """Number of bins and rounded bounds (reference ``get_dim``,
    ``falcon/cluster/spectrum.py:172-199``).

    Delegates to ``preprocess.spectrum.get_dim`` so the vectorizer and
    the preprocessing layer can never disagree by one bin: a float64
    re-implementation here rounded boundary m/z values differently from
    get_dim's deliberate float32 (reference-njit bit parity) arithmetic.
    """
    from ..preprocess.spectrum import get_dim

    return get_dim(min_mz, max_mz, bin_size)
