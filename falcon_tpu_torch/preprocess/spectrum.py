"""Spectrum preprocessing.

First-party, vectorized NumPy implementation of the reference's
preprocessing chain (``falcon/cluster/spectrum.py:73-169``), which itself
delegates to spectrum_utils 0.3.5.  The exact behavioral contract
reproduced here:

1. restrict m/z range to ``[mz_min, mz_max]`` (inclusive; spectrum_utils
   ``set_mz_range``),
2. validity gate: >= ``min_peaks`` peaks and m/z span >= ``min_mz_range``
   (``spectrum.py:27-52``), else the spectrum is rejected (returns None),
3. remove peaks within ``remove_precursor_tolerance`` Da of the precursor
   ion at every fragment charge 1..Z (spectrum_utils
   ``remove_precursor_peak`` with isotope=0; the neutral peptide mass is
   ``(precursor_mz - proton) * Z``); a ``None`` charge is temporarily
   treated as charge 1 (``spectrum.py:139-149``); re-validate,
4. remove peaks below ``min_intensity`` * base-peak intensity (strictly
   greater-than survives) and keep only the ``max_peaks_used`` most intense
   peaks (spectrum_utils ``filter_intensity``); re-validate,
5. scale intensities: 'root' -> sqrt, 'log' -> log2(x+1), 'rank' ->
   ``max_rank - descending_rank`` (spectrum_utils ``scale_intensity``),
6. L2-normalize intensities (``spectrum.py:55-70``), so downstream cosine
   similarity is a plain sum of matched intensity products.

The output is a plain dict with the same keys the reference stores in its
Lance datasets (``spectrum.py:160-169``).
"""

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..ms_io.containers import Spectrum

# Proton mass used by spectrum_utils for precursor-peak removal.
PROTON = 1.0072766

ProcessedSpectrum = Dict[str, Union[str, int, float, np.ndarray]]


def get_dim(
    min_mz: float, max_mz: float, bin_size: float
) -> Tuple[int, float, float]:
    """Number of bins and rounded m/z boundaries for a bin size.

    Mirrors reference ``falcon/cluster/spectrum.py:172-199`` (njit with
    float32 arguments, hence the float32 arithmetic here for bit parity).
    Returns (#bins, highest multiple of bin_size <= min_mz, lowest multiple
    of bin_size > max_mz).
    """
    min_mz, max_mz = np.float32(min_mz), np.float32(max_mz)
    bin_size = np.float32(bin_size)
    start_dim = min_mz - min_mz % bin_size
    end_dim = max_mz + bin_size - max_mz % bin_size
    return (
        int(math.ceil(float(end_dim - start_dim) / float(bin_size))),
        float(start_dim),
        float(end_dim),
    )


def _check_spectrum_valid(
    spectrum_mz: np.ndarray, min_peaks: int, min_mz_range: float
) -> bool:
    """Quality gate (reference ``spectrum.py:27-52``)."""
    n = len(spectrum_mz)
    # n > 0: an empty spectrum has no m/z span — without the guard,
    # min_peaks=0 lets n == 0 reach the [-1] index.
    return (
        n >= min_peaks
        and n > 0
        and spectrum_mz[-1] - spectrum_mz[0] >= min_mz_range
    )


def _remove_precursor_peak_mask(
    mz: np.ndarray,
    precursor_mz: float,
    precursor_charge: int,
    tol_mass: float,
) -> np.ndarray:
    """Mask of peaks to KEEP after removing precursor-ion peaks.

    Matches spectrum_utils 0.3.5 ``_get_non_precursor_peak_mask`` with
    isotope=0 and 'Da' tolerance: remove every peak within ``tol_mass`` of
    ``neutral_mass / c + proton`` for fragment charge c in 1..Z, where
    ``neutral_mass = (precursor_mz - proton) * Z``.
    """
    charge = max(int(precursor_charge), 1)
    neutral_mass = (precursor_mz - PROTON) * charge
    remove_mz = np.array(
        [neutral_mass / c + PROTON for c in range(charge, 0, -1)],
        dtype=np.float64,
    )
    # Vectorized: peak survives iff it is farther than tol from every
    # remove_mz value.
    diffs = np.abs(mz[:, None] - remove_mz[None, :])
    return ~(diffs <= tol_mass).any(axis=1)


def _filter_intensity_mask(
    intensity: np.ndarray, min_intensity: float, max_num_peaks: int
) -> np.ndarray:
    """Mask of peaks to keep (spectrum_utils 0.3.5 ``filter_intensity``).

    Keeps peaks with intensity strictly greater than
    ``min_intensity * base_peak_intensity``, then retains at most the
    ``max_num_peaks`` most intense peaks.  A stable sort is used so ties
    resolve deterministically by peak position.
    """
    order = np.argsort(intensity, kind="stable")
    threshold = min_intensity * intensity[order[-1]]
    start_i = int(np.searchsorted(intensity[order], threshold, side="right"))
    mask = np.zeros(len(intensity), np.bool_)
    mask[order[max(start_i, len(order) - max_num_peaks):]] = True
    return mask


def _scale_intensity(
    intensity: np.ndarray, scaling: Optional[str], max_rank: int
) -> np.ndarray:
    """Peak-intensity scaling (spectrum_utils 0.3.5 ``scale_intensity``)."""
    if scaling == "root":
        return np.sqrt(intensity).astype(np.float32)
    if scaling == "log":
        return (np.log1p(intensity) / np.log(2)).astype(np.float32)
    if scaling == "rank":
        if max_rank < len(intensity):
            raise ValueError(
                "`max_rank` should be greater than or equal to the number "
                "of peaks in the spectrum"
            )
        desc_rank = np.argsort(np.argsort(intensity, kind="stable")[::-1],
                               kind="stable")
        return (max_rank - desc_rank).astype(np.float32)
    return intensity


def process_spectrum(
    spectrum: Spectrum,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
) -> Optional[ProcessedSpectrum]:
    """Process one spectrum; returns None if it fails a quality gate.

    Reference: ``falcon/cluster/spectrum.py:73-169``.
    """
    mz = np.asarray(spectrum.mz, np.float32)
    intensity = np.asarray(spectrum.intensity, np.float32)

    # 0. Non-finite gate (documented divergence, SURVEY.md §3.5): a
    # NaN/inf precursor m/z silently DISABLES precursor-peak removal
    # (every NaN comparison is false) and breaks the sorted-precursor
    # invariants that charge bucketing and the banded kNN rely on; a
    # non-finite RT would poison the RT-refinement sort the same way
    # (missing RT is always the finite -1.0).  Non-finite peak entries
    # are dropped pairwise before any filter sees them.  The native
    # ingest chain applies the same gates (falcon_ingest.cc preprocess
    # step 0 + the per-format RT checks).
    if not (math.isfinite(spectrum.precursor_mz)
            and math.isfinite(spectrum.retention_time)):
        return None
    finite = np.isfinite(mz) & np.isfinite(intensity)
    if not finite.all():
        mz, intensity = mz[finite], intensity[finite]

    # 1. m/z range restriction (inclusive bounds).
    if mz_min is not None or mz_max is not None:
        lo = -np.inf if mz_min is None else mz_min
        hi = np.inf if mz_max is None else mz_max
        keep = (mz >= lo) & (mz <= hi)
        mz, intensity = mz[keep], intensity[keep]
    # 2. Validity gate.
    if not _check_spectrum_valid(mz, min_peaks, min_mz_range):
        return None

    # 3. Precursor-peak removal (None charge treated as 1,
    #    reference spectrum.py:139-149).
    if remove_precursor_tolerance is not None:
        keep = _remove_precursor_peak_mask(
            mz,
            spectrum.precursor_mz,
            spectrum.precursor_charge
            if spectrum.precursor_charge is not None
            else 1,
            remove_precursor_tolerance,
        )
        mz, intensity = mz[keep], intensity[keep]
        if not _check_spectrum_valid(mz, min_peaks, min_mz_range):
            return None

    # 4. Intensity filtering.
    if min_intensity is not None or max_peaks_used is not None:
        min_intensity = 0.0 if min_intensity is None else min_intensity
        max_num = len(mz) if max_peaks_used is None else max_peaks_used
        keep = _filter_intensity_mask(intensity, min_intensity, max_num)
        mz, intensity = mz[keep], intensity[keep]
        if not _check_spectrum_valid(mz, min_peaks, min_mz_range):
            return None

    # 5. Scaling + 6. L2 normalization.  With no peak cap, rank scaling
    # ranks over all retained peaks (mirrors the max_num handling above).
    intensity = _scale_intensity(
        intensity, scaling,
        max_rank=len(intensity) if max_peaks_used is None else max_peaks_used,
    )
    norm = float(np.linalg.norm(intensity))
    if norm == 0.0:
        # All-zero intensities (reachable when the intensity filter is
        # disabled) would normalize to a NaN vector — reject instead.
        return None
    intensity = (intensity / norm).astype(np.float32)

    return {
        "identifier": spectrum.identifier,
        "precursor_mz": float(spectrum.precursor_mz),
        "precursor_charge": spectrum.precursor_charge,
        "mz": mz.astype(np.float32),
        "intensity": intensity,
        "retention_time": float(spectrum.retention_time),
        "filename": spectrum.filename,
    }
