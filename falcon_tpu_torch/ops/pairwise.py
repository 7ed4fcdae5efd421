"""All-pairs spectrum similarity: the two CUDA kernels and their callers.

Port of the exact backend's scoring in ``falcon_tpu/ops/pairwise.py``:

- ``panel_scores`` (K1) replaces the Pallas kernel ``panel_scores_pallas``:
  every (row, column) pair of a panel of spectra, or only the pairs above
  the global diagonal.  ``condensed_distances`` streams row panels of one
  large precursor interval through it.
- ``batched_block_scores`` (K4) replaces the XLA ``batched_block_scores``:
  every upper-triangle pair of many small intervals in one launch.  The
  intervals are ragged (``starts`` offsets) rather than padded to a common
  size, and the output is the concatenation of their condensed orders.
  ``grouped_condensed_distances`` feeds it.

Both kernels are the matching routine of ``csrc/matching.cuh`` at two
launch shapes (``csrc/pairwise.cu``).  Each wrapper checks its inputs,
launches its kernel for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs its plain version
(``*_plain``, built on ``ops/matching.py``), which is also what the kernel is
held against on the card.  Nothing falls back from one to the other.

Spectra are padded ``(n, 64)`` float32 m/z and intensity arrays (padding
m/z ``PAD_MZ``, intensity 0, as ``falcon_tpu.store.store.padded_peaks``
makes them), so padded peaks never match.
"""

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..utils.profiling import profiler
from . import _build
from .matching import DEFAULT_ROUNDS, f32_tolerance, indexed_pair_scores

PAD_MZ = -1e6  # padding m/z: outside every tolerance window
KERNEL_PEAKS = 64  # peaks per spectrum the CUDA kernels take
_MAX_PANEL_ROWS = 65535  # K1's grid y limit


def _check_spectra(name: str, *arrays: torch.Tensor) -> torch.device:
    """Raise unless all arrays are contiguous float32 (n, P) tensors on
    one CPU or CUDA device, with P = 64 on CUDA; returns the device."""
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name}: expected torch tensors, got {type(a)}")
    device = arrays[0].device
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: m/z and intensity must be float32, "
                            f"got {a.dtype}")
        if a.ndim != 2:
            raise ValueError(f"{name}: spectra must be (n, P), got shape "
                             f"{tuple(a.shape)}")
        if a.device != device:
            raise ValueError(f"{name}: tensors on {a.device} and {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if len({a.shape[1] for a in arrays}) != 1:
        raise ValueError(f"{name}: spectra differ in padded peak count")
    if device.type == "cuda":
        if arrays[0].shape[1] != KERNEL_PEAKS:
            raise ValueError(
                f"{name}: the CUDA kernel takes {KERNEL_PEAKS} peaks per "
                f"spectrum (max_peaks_used <= {KERNEL_PEAKS}), got "
                f"{arrays[0].shape[1]}")
    elif device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def panel_scores(
    mz_rows: torch.Tensor,
    int_rows: torch.Tensor,
    mz_cols: torch.Tensor,
    int_cols: torch.Tensor,
    row_offset: int,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    upper_only: bool = False,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scores of every (row, column) spectrum pair of a panel (K1).

    ``mz_rows``/``int_rows``: (n_rows, P); ``mz_cols``/``int_cols``:
    (n_cols, P).  ``row_offset`` is the global index of row 0: with
    ``upper_only`` only the pairs with column > row_offset + row are
    scored, and the others are 0.  Returns (scores f32, matches i32 or
    None when ``with_matches`` is False), each (n_rows, n_cols).
    """
    device = _check_spectra("panel_scores", mz_rows, int_rows, mz_cols,
                            int_cols)
    if mz_rows.shape != int_rows.shape or mz_cols.shape != int_cols.shape:
        raise ValueError("panel_scores: m/z and intensity shapes differ")
    if rounds < 0:
        raise ValueError(f"panel_scores: rounds must be >= 0, got {rounds}")
    if device.type == "cpu":
        return panel_scores_plain(mz_rows, int_rows, mz_cols, int_cols,
                                  row_offset, fragment_tol, rounds,
                                  upper_only, with_matches)
    n_rows, n_cols = mz_rows.shape[0], mz_cols.shape[0]
    if n_rows > _MAX_PANEL_ROWS:
        raise ValueError(f"panel_scores: at most {_MAX_PANEL_ROWS} rows "
                         f"per panel, got {n_rows}")
    lib = _build.library()
    scores = torch.zeros((n_rows, n_cols), dtype=torch.float32,
                         device=device)
    matches = (torch.zeros((n_rows, n_cols), dtype=torch.int32,
                           device=device) if with_matches else None)
    with torch.cuda.device(device):
        err = lib.falcon_panel_scores(
            mz_rows.data_ptr(), int_rows.data_ptr(), n_rows,
            mz_cols.data_ptr(), int_cols.data_ptr(), n_cols,
            int(row_offset), f32_tolerance(fragment_tol), int(rounds),
            int(bool(upper_only)), scores.data_ptr(),
            matches.data_ptr() if with_matches else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check_launch("K1 panel", err)
    panel_scores.launches += 1
    return scores, matches


panel_scores.launches = 0


def panel_scores_plain(
    mz_rows: torch.Tensor,
    int_rows: torch.Tensor,
    mz_cols: torch.Tensor,
    int_cols: torch.Tensor,
    row_offset: int,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    upper_only: bool = False,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`panel_scores` (any device)."""
    device = mz_rows.device
    n_rows, n_cols = mz_rows.shape[0], mz_cols.shape[0]
    ii = torch.arange(n_rows, device=device).repeat_interleave(n_cols)
    jj = torch.arange(n_cols, device=device).repeat(n_rows)
    if upper_only:
        keep = jj > ii + int(row_offset)
        ii, jj = ii[keep], jj[keep]
    s, m = indexed_pair_scores(mz_rows, int_rows, ii, mz_cols, int_cols, jj,
                               fragment_tol, rounds)
    scores = torch.zeros((n_rows, n_cols), dtype=torch.float32,
                         device=device)
    scores[ii, jj] = s
    if not with_matches:
        return scores, None
    matches = torch.zeros((n_rows, n_cols), dtype=torch.int32,
                          device=device)
    matches[ii, jj] = m
    return scores, matches


def _check_starts(name: str, starts: torch.Tensor, n: int,
                  device: torch.device) -> None:
    if (starts.dtype != torch.int64 or starts.ndim != 1
            or starts.device != device or starts.shape[0] < 2
            or not starts.is_contiguous()):
        raise ValueError(f"{name}: starts must be a contiguous 1-D int64 "
                         f"tensor of >= 2 offsets on {device}")
    if (int(starts[0]) != 0 or int(starts[-1]) != n
            or bool((starts[1:] < starts[:-1]).any())):
        raise ValueError(f"{name}: starts must rise from 0 to {n}")


def _pair_starts(starts: torch.Tensor) -> torch.Tensor:
    """First condensed pair of each interval, plus the total at the end."""
    sizes = starts[1:] - starts[:-1]
    out = torch.zeros_like(starts)
    out[1:] = torch.cumsum(sizes * (sizes - 1) // 2, 0)
    return out


def batched_block_scores(
    mz: torch.Tensor,
    intensity: torch.Tensor,
    starts: torch.Tensor,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every upper-triangle pair of many intervals in one launch (K4).

    ``mz``/``intensity``: (n, P), interval g being rows
    ``starts[g]:starts[g + 1]`` (``starts``: int64, from 0 to n).  Returns
    (scores f32, matches i32 or None), each holding the condensed pairs
    (i < j, row-major) of interval 0, then interval 1, and so on.
    """
    device = _check_spectra("batched_block_scores", mz, intensity)
    if mz.shape != intensity.shape:
        raise ValueError("batched_block_scores: m/z and intensity shapes "
                         "differ")
    if rounds < 0:
        raise ValueError(f"batched_block_scores: rounds must be >= 0, got "
                         f"{rounds}")
    _check_starts("batched_block_scores", starts, mz.shape[0], device)
    if device.type == "cpu":
        return batched_block_scores_plain(mz, intensity, starts,
                                          fragment_tol, rounds, with_matches)
    pair_starts = _pair_starts(starts)
    n_pairs = int(pair_starts[-1])
    lib = _build.library()
    scores = torch.zeros(n_pairs, dtype=torch.float32, device=device)
    matches = (torch.zeros(n_pairs, dtype=torch.int32, device=device)
               if with_matches else None)
    with torch.cuda.device(device):
        err = lib.falcon_grouped_scores(
            mz.data_ptr(), intensity.data_ptr(), starts.data_ptr(),
            pair_starts.data_ptr(), starts.shape[0] - 1, n_pairs,
            f32_tolerance(fragment_tol), int(rounds), scores.data_ptr(),
            matches.data_ptr() if with_matches else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check_launch("K4 grouped", err)
    batched_block_scores.launches += 1
    return scores, matches


batched_block_scores.launches = 0


def batched_block_scores_plain(
    mz: torch.Tensor,
    intensity: torch.Tensor,
    starts: torch.Tensor,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`batched_block_scores` (any
    device)."""
    bounds = starts.tolist()
    parts_i: List[torch.Tensor] = []
    parts_j: List[torch.Tensor] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a >= 2:
            iu = torch.triu_indices(b - a, b - a, 1, device=mz.device)
            parts_i.append(iu[0] + a)
            parts_j.append(iu[1] + a)
    empty = torch.zeros(0, dtype=torch.int64, device=mz.device)
    ii = torch.cat(parts_i) if parts_i else empty
    jj = torch.cat(parts_j) if parts_j else empty
    scores, matches = indexed_pair_scores(mz, intensity, ii, mz, intensity,
                                          jj, fragment_tol, rounds)
    return scores, (matches if with_matches else None)


def grouped_condensed_distances(
    interval_peaks,  # list of (mz (m_i, P), intensity (m_i, P)) numpy
    fragment_tol: float,
    min_matches: int = 0,
    rounds: int = DEFAULT_ROUNDS,
    max_group_pairs: int = 2**24,
    device=None,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Condensed distance matrices of many small intervals, batched.

    Consecutive intervals are scored together, up to ``max_group_pairs``
    pairs per launch (at least one interval each).  Yields (interval
    index, condensed float32 pdist), where distance = 1 - score and a pair
    with fewer than ``min_matches`` matched peaks has distance 1.
    """
    dev = resolve_device(device)
    groups: List[List[int]] = []
    group_pairs = 0
    for idx, (mz, _) in enumerate(interval_peaks):
        m = mz.shape[0]
        if not groups or group_pairs + m * (m - 1) // 2 > max_group_pairs:
            groups.append([])
            group_pairs = 0
        groups[-1].append(idx)
        group_pairs += m * (m - 1) // 2

    with_matches = min_matches > 0
    for group in groups:
        sizes = np.array([interval_peaks[k][0].shape[0] for k in group],
                         np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        pair_starts = np.concatenate(
            [[0], np.cumsum(sizes * (sizes - 1) // 2)]).astype(np.int64)
        mz = torch.from_numpy(np.concatenate(
            [np.asarray(interval_peaks[k][0], np.float32) for k in group]
        )).to(dev)
        intensity = torch.from_numpy(np.concatenate(
            [np.asarray(interval_peaks[k][1], np.float32) for k in group]
        )).to(dev)
        with profiler.phase("score groups (K4)"):
            scores, matches = batched_block_scores(
                mz, intensity, torch.from_numpy(starts).to(dev),
                fragment_tol, rounds, with_matches,
            )
            if with_matches:
                scores = torch.where(matches >= min_matches, scores, 0.0)
            dist = 1.0 - scores
            synchronize(dev)
        with profiler.phase("groups to host"):
            dist = dist.cpu().numpy()
        for b, idx in enumerate(group):
            yield idx, dist[pair_starts[b]:pair_starts[b + 1]]


def condensed_distances(
    mz: np.ndarray,
    intensity: np.ndarray,
    fragment_tol: float,
    min_matches: int = 0,
    rounds: int = DEFAULT_ROUNDS,
    panel_rows: int = 2048,
    device=None,
) -> np.ndarray:
    """Condensed upper-triangle distance matrix of one block of spectra.

    Semantics of the reference's ``compute_condensed_distance_matrix``:
    distance = 1 - similarity, with similarity 0 when fewer than
    ``min_matches`` peaks match.  Row panels of ``panel_rows`` spectra go
    through K1 against the whole block, so device memory is
    O(panel_rows * n); each panel's upper triangle is gathered on the
    device, which is exactly the panel's contiguous slice of the condensed
    vector, and only that slice is copied to the host.
    """
    n = mz.shape[0]
    if n < 2:
        return np.zeros(0, np.float32)
    dev = resolve_device(device)
    mz_t = torch.from_numpy(np.ascontiguousarray(mz, np.float32)).to(dev)
    int_t = torch.from_numpy(
        np.ascontiguousarray(intensity, np.float32)).to(dev)
    out = np.ones(n * (n - 1) // 2, np.float32)
    with_matches = min_matches > 0
    cols = torch.arange(n, device=dev)
    for r0 in range(0, n - 1, panel_rows):
        r1 = min(r0 + panel_rows, n)
        with profiler.phase("score panels (K1)"):
            scores, matches = panel_scores(
                mz_t[r0:r1], int_t[r0:r1], mz_t, int_t, r0, fragment_tol,
                rounds, upper_only=True, with_matches=with_matches,
            )
            synchronize(dev)
        with profiler.phase("panels to host"):
            if with_matches:
                scores = torch.where(matches >= min_matches, scores, 0.0)
            upper = cols[None, :] > (
                r0 + torch.arange(r1 - r0, device=dev))[:, None]
            segment = (1.0 - scores[upper]).cpu().numpy()
            start = n * r0 - r0 * (r0 + 1) // 2
            out[start:start + segment.shape[0]] = segment
    return out
