"""Plain reference of the clustering the benchmark's cells run.

falcon's published algorithm, written for the benchmark alone in NumPy,
SciPy and plain PyTorch: it imports nothing of the program and reads only
the generated spectra (the values the MGF file holds).  Its steps:

1. preprocessing (falcon's ``spectrum.py`` through spectrum_utils 0.3.5):
   peaks inside the m/z range, at least ``min_peaks`` peaks spanning
   ``min_mz_range``, precursor peaks removed within
   ``remove_precursor_tol`` at every fragment charge, peaks above
   ``min_intensity`` of the base peak, the ``max_peaks_used`` most intense
   ones, intensities L2-normalised; a spectrum that fails a gate is dropped;
2. per charge, spectra sorted by precursor m/z and cut into intervals where
   neighbours lie more than ``precursor_tol_ppm`` apart (blocks of
   ``batch_size`` or more are cut evenly);
3. every pair of an interval scored by the peak-matching cosine: the
   products of the intensities of peaks within ``fragment_tol`` matched
   greedily, largest product first, each peak at most once (falcon's
   ``cosine_fast``), summed and clipped to [0, 1]; a pair with fewer than
   ``min_matches`` matched peaks scores 0;
4. SciPy's hierarchical clustering of each interval on distance
   ``1 - score`` with ``linkage``, cut at ``threshold``;
5. each cluster split where its precursors span more than
   ``precursor_tol_ppm`` (complete linkage of the precursor m/z in ppm of
   the smaller, cut there); groups of one spectrum are unclustered.

The matching runs on ``device`` in chunks of pairs, as rounds of
locally dominant selection (each weight that is the largest of its row and
of its column is taken, ties to the lowest index) until no weight is left;
with distinct products that is the greedy matching.  ``dtype`` is the
precision of the intensities, products and sums: float32 as the
configuration states, or bfloat16 for the control.
"""

from typing import Dict, Tuple

import numpy as np
import scipy.cluster.hierarchy as sch
import torch

PROTON = 1.0072766
PAD_MZ = -1.0e4


def mz_bounds(min_mz: float, max_mz: float, bin_size: float) -> Tuple[float,
                                                                       float]:
    """falcon's ``get_dim`` bounds (float32 arithmetic): the highest
    multiple of ``bin_size`` at or below ``min_mz`` and the lowest above
    ``max_mz``."""
    lo, hi, b = np.float32(min_mz), np.float32(max_mz), np.float32(bin_size)
    return float(lo - lo % b), float(hi + b - hi % b)


def _segment_valid(keep, mz, seg, offsets, n, min_peaks, min_mz_range):
    """Per spectrum: at least ``min_peaks`` kept peaks whose m/z span is at
    least ``min_mz_range`` (peaks are sorted by m/z)."""
    count = np.bincount(seg[keep], minlength=n)
    first = np.where(keep, mz, np.inf)
    last = np.where(keep, mz, -np.inf)
    starts = offsets[:-1]
    lo = np.minimum.reduceat(first, starts)
    hi = np.maximum.reduceat(last, starts)
    with np.errstate(invalid="ignore"):
        span = (hi - lo).astype(np.float32)
    return (count >= min_peaks) & (count > 0) & (span >= min_mz_range)


def preprocess(corpus, s: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kept spectrum ids, padded m/z (n_kept, P) float32, padded
    normalised intensities (n_kept, P) float32), P the most peaks kept."""
    n = len(corpus)
    offsets = corpus.offsets
    counts = np.diff(offsets)
    if (counts == 0).any():
        raise ValueError("the reference takes spectra of one peak or more")
    seg = np.repeat(np.arange(n), counts)
    mz = corpus.mz.astype(np.float32)
    inten = corpus.intensity.astype(np.float32)
    lo, hi = mz_bounds(s["min_mz"], s["max_mz"], s["fragment_tol"])
    keep = (mz >= np.float32(lo)) & (mz <= np.float32(hi))
    valid = _segment_valid(keep, mz, seg, offsets, n, s["min_peaks"],
                           s["min_mz_range"])

    charge = np.maximum(corpus.charge, 1)
    neutral = (corpus.precursor_mz - PROTON) * charge
    mz64 = mz.astype(np.float64)
    for c in range(1, int(charge.max(initial=1)) + 1):
        ion = neutral / c + PROTON
        near = (c <= charge[seg]) & (
            np.abs(mz64 - ion[seg]) <= s["remove_precursor_tol"])
        keep &= ~near
    valid &= _segment_valid(keep, mz, seg, offsets, n, s["min_peaks"],
                            s["min_mz_range"])

    base = np.zeros(n, np.float32)
    np.maximum.at(base, seg[keep], inten[keep])
    above = inten > np.float32(s["min_intensity"]) * base[seg]
    # Rank from the most intense down; among equal intensities the later
    # peak ranks higher (a stable ascending sort, read from its end).
    cand = np.flatnonzero(keep & above)
    by = cand[np.lexsort((cand, inten[cand], seg[cand]))]
    seg_by = seg[by]
    last_of_seg = np.r_[seg_by[1:] != seg_by[:-1], True]
    ends = np.flatnonzero(last_of_seg)
    end_of = np.repeat(ends, np.diff(np.r_[-1, ends]))
    from_top = end_of - np.arange(len(by))
    keep_final = np.zeros(len(mz), bool)
    keep_final[by[from_top < s["max_peaks_used"]]] = True
    valid &= _segment_valid(keep_final, mz, seg, offsets, n,
                            s["min_peaks"], s["min_mz_range"])

    kept_ids = np.flatnonzero(valid)
    peak_ok = keep_final & valid[seg]
    p_seg = seg[peak_ok]
    p_mz = mz[peak_ok]
    p_int = inten[peak_ok].astype(np.float64)
    norm = np.sqrt(np.bincount(p_seg, weights=p_int * p_int, minlength=n))
    p_int = (p_int / norm[p_seg]).astype(np.float32)
    row = np.searchsorted(kept_ids, p_seg)
    n_kept = len(kept_ids)
    per_row = np.bincount(row, minlength=n_kept)
    width = max(int(per_row.max(initial=1)), 1)
    col = np.arange(len(row)) - np.repeat(
        np.cumsum(per_row) - per_row, per_row)
    mz_pad = np.full((n_kept, width), PAD_MZ, np.float32)
    int_pad = np.zeros((n_kept, width), np.float32)
    mz_pad[row, col] = p_mz
    int_pad[row, col] = p_int
    return kept_ids, mz_pad, int_pad


def interval_splits(sorted_mz: np.ndarray, tol_ppm: float,
                    batch_size: int) -> np.ndarray:
    """Bounds of the precursor intervals of sorted precursor m/z."""
    n = len(sorted_mz)
    gaps = np.flatnonzero(
        (sorted_mz[1:] - sorted_mz[:-1]) / sorted_mz[:-1] * 1e6 > tol_ppm
    ) + 1
    splits = [0]
    for boundary in gaps.tolist() + [n]:
        size = boundary - splits[-1]
        if size <= 0:
            continue
        if size < batch_size:
            splits.append(boundary)
            continue
        n_chunks = -(-size // batch_size)
        chunk = size // n_chunks
        for i in range(n_chunks):
            splits.append(splits[-1] + chunk + (1 if i < size % n_chunks
                                                else 0))
    return np.asarray(splits, np.int64)


def _first(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """``mask`` with only the first True along ``dim`` kept."""
    idx = mask.to(torch.uint8).argmax(dim, keepdim=True)
    shape = [1] * mask.ndim
    shape[dim] = mask.shape[dim]
    pos = torch.arange(mask.shape[dim], device=mask.device).view(shape)
    return mask & (pos == idx)


def pair_distances(mz: torch.Tensor, inten: torch.Tensor, ii: torch.Tensor,
                   jj: torch.Tensor, fragment_tol: float, min_matches: int,
                   dtype: torch.dtype, chunk: int = 1 << 15) -> torch.Tensor:
    """``1 - score`` of the pairs (ii[t], jj[t]) in ``dtype``."""
    out = torch.empty(len(ii), dtype=dtype, device=mz.device)
    tol = torch.tensor(fragment_tol, dtype=torch.float32)
    inten = inten.to(dtype)
    for s in range(0, len(ii), chunk):
        a, b = ii[s:s + chunk], jj[s:s + chunk]
        near = (mz[a][:, :, None] - mz[b][:, None, :]).abs() <= tol
        w = torch.where(near, inten[a][:, :, None] * inten[b][:, None, :],
                        torch.zeros((), dtype=dtype, device=mz.device))
        score = torch.zeros(len(a), dtype=dtype, device=mz.device)
        matched = torch.zeros(len(a), dtype=torch.int64, device=mz.device)
        while bool((w > 0).any()):
            pick = ((w == w.amax(2, keepdim=True))
                    & (w == w.amax(1, keepdim=True)) & (w > 0))
            pick = _first(_first(pick, 2), 1)
            score = score + torch.where(pick, w, 0).sum((1, 2), dtype=dtype)
            matched += pick.sum((1, 2))
            w = torch.where(pick.any(2, keepdim=True)
                            | pick.any(1, keepdim=True), 0, w)
        score = score.clamp(0, 1)
        if min_matches > 0:
            score = torch.where(matched >= min_matches, score, 0)
        out[s:s + chunk] = 1 - score
    return out


def _triu(m: int, cache: Dict) -> Tuple[np.ndarray, np.ndarray]:
    if m not in cache:
        cache[m] = np.triu_indices(m, 1)
    return cache[m]


def _flat_clusters(d: np.ndarray, m: int, method: str,
                   threshold: float) -> np.ndarray:
    """Flat cluster ids (from 0) of ``m`` spectra with condensed
    distances ``d``, cut at ``threshold``."""
    if d.max() <= threshold:
        return np.zeros(m, np.int64)
    if d.min() > threshold:
        return np.arange(m)
    z = sch.linkage(d, method=method)
    return sch.fcluster(z, threshold, criterion="distance") - 1


def _split_precursors(pmz: np.ndarray, tol_ppm: float) -> np.ndarray:
    """Groups of one cluster's precursors: complete linkage on the ppm
    distance relative to the smaller m/z, cut at ``tol_ppm``."""
    if (pmz.max() - pmz.min()) / pmz.min() * 1e6 <= tol_ppm:
        return np.zeros(len(pmz), np.int64)
    a, b = np.triu_indices(len(pmz), 1)
    d = np.abs(pmz[a] - pmz[b]) / np.minimum(pmz[a], pmz[b]) * 1e6
    return sch.fcluster(sch.linkage(d, "complete"), tol_ppm,
                        criterion="distance") - 1


def cluster(corpus, s: Dict, device: torch.device,
            dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Reference labels of every spectrum of ``corpus``: -1 for a spectrum
    that preprocessing drops, else its cluster id (every unclustered
    spectrum its own)."""
    kept, mz_pad, int_pad = preprocess(corpus, s)
    labels = np.full(len(corpus), -1, np.int64)
    mz_t = torch.from_numpy(mz_pad).to(device)
    int_t = torch.from_numpy(int_pad).to(device)
    cache: Dict = {}
    next_label = 0
    charge = corpus.charge[kept]
    pmz_all = corpus.precursor_mz[kept]
    for z in np.unique(charge):
        rows = np.flatnonzero(charge == z)
        rows = rows[np.argsort(pmz_all[rows], kind="stable")]
        pmz = pmz_all[rows]
        splits = interval_splits(pmz, s["precursor_tol_ppm"],
                                 s["batch_size"])
        sizes = np.diff(splits)
        ii_parts, jj_parts = [], []
        for a, m in zip(splits[:-1].tolist(), sizes.tolist()):
            if m >= 2:
                ti, tj = _triu(m, cache)
                ii_parts.append(rows[a + ti])
                jj_parts.append(rows[a + tj])
        dist = np.zeros(0)
        if ii_parts:
            ii = torch.from_numpy(np.concatenate(ii_parts)).to(device)
            jj = torch.from_numpy(np.concatenate(jj_parts)).to(device)
            dist = pair_distances(
                mz_t, int_t, ii, jj, s["fragment_tol"], s["min_matches"],
                dtype).float().cpu().numpy().astype(np.float64)
        pos = 0
        for a, m in zip(splits[:-1].tolist(), sizes.tolist()):
            members = rows[a:a + m]
            if m == 1:
                labels[kept[members]] = next_label
                next_label += 1
                continue
            d = dist[pos:pos + m * (m - 1) // 2]
            pos += m * (m - 1) // 2
            flat = _flat_clusters(d, m, s["linkage"], s["threshold"])
            for f in np.unique(flat):
                grp = members[flat == f]
                sub = (_split_precursors(pmz_all[grp],
                                         s["precursor_tol_ppm"])
                       if len(grp) > 1 else np.zeros(1, np.int64))
                for g in np.unique(sub):
                    part = grp[sub == g]
                    if len(part) >= 2:
                        labels[kept[part]] = next_label
                        next_label += 1
                    else:
                        labels[kept[part]] = np.arange(
                            next_label, next_label + len(part))
                        next_label += len(part)
    return labels


def disagreement(program: np.ndarray, reference: np.ndarray) -> float:
    """Share of spectra whose cluster differs between two labellings of
    the same spectra (-1 = absent from that side's output).

    A spectrum agrees when both sides keep it and the spectra sharing its
    cluster are the same on both sides; the share is taken over the
    spectra that either side keeps."""
    present_p, present_r = program >= 0, reference >= 0
    either = present_p | present_r
    both = np.flatnonzero(present_p & present_r)
    agree = np.zeros(len(program), bool)

    def sizes(labels, where):
        """Size of each spectrum's cluster among the spectra ``where``."""
        _, inv, cnt = np.unique(labels[where], return_inverse=True,
                                return_counts=True)
        out = np.zeros(len(labels), np.int64)
        out[where] = cnt[inv]
        return out

    if len(both):
        p_full = sizes(program, present_p)[both]
        r_full = sizes(reference, present_r)[both]
        p_both = sizes(program, both)[both]
        _, p_code = np.unique(program[both], return_inverse=True)
        _, r_code = np.unique(reference[both], return_inverse=True)
        r_min = np.full(p_code.max() + 1, np.iinfo(np.int64).max)
        r_max = np.full(p_code.max() + 1, -1)
        np.minimum.at(r_min, p_code, r_code)
        np.maximum.at(r_max, p_code, r_code)
        # The program cluster lies inside one reference cluster, has no
        # member the reference drops, and is as large as it.
        agree[both] = ((r_min[p_code] == r_max[p_code])
                       & (p_full == p_both) & (p_both == r_full))
    n = int(either.sum())
    return float((either & ~agree).sum()) / n if n else 0.0


def exact_settings(settings: Dict) -> Dict:
    """The settings the reference reads, checked for presence."""
    keys = ("precursor_tol_ppm", "fragment_tol", "threshold", "linkage",
            "min_matches", "min_peaks", "min_mz_range", "min_mz", "max_mz",
            "remove_precursor_tol", "min_intensity", "max_peaks_used",
            "batch_size")
    missing = [k for k in keys if k not in settings]
    if missing:
        raise KeyError(f"reference settings lack {missing}")
    return {k: settings[k] for k in keys}
