"""Spectrum-pair similarity: three CUDA kernels and their callers.

Port of the scoring in ``falcon_tpu/ops/pairwise.py``:

- ``panel_scores`` (K1) replaces the Pallas kernel ``panel_scores_pallas``:
  every (row, column) pair of a panel of spectra, or only the pairs above
  the global diagonal.  ``condensed_distances`` streams row panels of one
  large precursor interval through it.
- ``batched_block_scores`` (K4) replaces the XLA ``batched_block_scores``:
  every upper-triangle pair of many small intervals in one launch.  The
  intervals are ragged (``starts`` offsets) rather than padded to a common
  size, and the output is the concatenation of their condensed orders.
  ``grouped_condensed_distances`` feeds it.
- ``pair_list_scores`` replaces the exact scoring of the XLA
  ``rerank_scan_body`` (``falcon_tpu/ops/rerank.py``): each query row
  against its own list of pool ids.  ``pruned_condensed_distances`` feeds
  it the pairs of a large linkage component whose spread upper bound
  (``ub_pass_counts``, ``ub_pass_topk``) can reach ``1 - eps``.

All three run one matching routine family (``csrc/matching.cuh``): a row
spectrum sorted by m/z once, each column peak's run of row peaks within
tolerance found by binary search, then the matching rounds on those peak
pairs only (``csrc/pairwise.cu`` says how each launch shares its sorted
rows).  Each wrapper checks its inputs, launches its kernel for CUDA
tensors and counts the launch in its ``launches`` attribute; for CPU
tensors it runs its plain version (``*_plain``, built on
``ops/matching.py``), which is also what the kernel is held against on the
card.  Nothing falls back from one to the other.  K4's table of intervals
(``_grouped_layout``) is built here on the host, from the offsets of the
intervals, and each warp of the kernel finds its work item from it.

Spectra are padded ``(n, 64)`` float32 m/z and intensity arrays (padding
m/z ``PAD_MZ``, intensity 0, as ``falcon_tpu.store.store.padded_peaks``
makes them), so padded peaks never match.
"""

import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..utils.profiling import profiler
from . import _build
from .knn import NEG, _pow2_at_least, refuse_tf32, stable_topk
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


_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (charges may be clustered on two
    threads at once, and ``+=`` on an attribute is not atomic)."""
    with _launch_lock:
        wrapper.launches += 1


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
    count_launch(panel_scores)
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
                  device: torch.device) -> np.ndarray:
    """Raise unless ``starts`` is a contiguous 1-D int64 tensor on
    ``device`` rising from 0 to ``n``; returns its host copy, the one copy
    (and host sync) the check makes."""
    if (starts.dtype != torch.int64 or starts.ndim != 1
            or starts.device != device or starts.shape[0] < 2
            or not starts.is_contiguous()):
        raise ValueError(f"{name}: starts must be a contiguous 1-D int64 "
                         f"tensor of >= 2 offsets on {device}")
    host = starts.cpu().numpy()
    if host[0] != 0 or host[-1] != n or (host[1:] < host[:-1]).any():
        raise ValueError(f"{name}: starts must rise from 0 to {n}")
    return host


ITEM_COLS = 32  # columns per K4 work item: one warp, one lane each
MAX_INTERVAL = 1 << 16  # K4's largest interval (its item search is in int)
SORTED_BYTES = 3 * 4 * KERNEL_PEAKS  # K4's sorted spectrum: m/z, int, index


def _grouped_layout(bounds: np.ndarray) -> np.ndarray:
    """K4's table of intervals, from their offsets ``bounds`` (host).

    A work item is (row i, a run of up to ``ITEM_COLS`` consecutive
    columns j > i of i's interval), and items are numbered in the
    condensed order, so row r of an m-spectrum interval has
    ceil((m - 1 - r) / ITEM_COLS) and the interval the sum of ceil(c /
    ITEM_COLS) over c < m (the kernel's ``tail_items``).  Returns (2, G + 1)
    int64: the first item of each interval, then its first condensed pair,
    each row ending in its total.  Raises on an interval of more than
    ``MAX_INTERVAL`` spectra.
    """
    sizes = np.diff(bounds)
    if sizes.shape[0] and sizes.max() > MAX_INTERVAL:
        raise ValueError(f"batched_block_scores: an interval of "
                         f"{sizes.max()} spectra, more than {MAX_INTERVAL}")
    a, b = np.divmod(np.maximum(sizes - 1, 0), ITEM_COLS)
    layout = np.zeros((2, sizes.shape[0] + 1), np.int64)
    np.cumsum(ITEM_COLS * a * (a + 1) // 2 + b * (a + 1), out=layout[0, 1:])
    np.cumsum(sizes * (sizes - 1) // 2, out=layout[1, 1:])
    return layout


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
    (i < j, row-major) of interval 0, then interval 1, and so on.  On the
    card: a pre-pass sorts each spectrum once, then one warp per work item
    of :func:`_grouped_layout`.
    """
    device = _check_spectra("batched_block_scores", mz, intensity)
    if mz.shape != intensity.shape:
        raise ValueError("batched_block_scores: m/z and intensity shapes "
                         "differ")
    if rounds < 0:
        raise ValueError(f"batched_block_scores: rounds must be >= 0, got "
                         f"{rounds}")
    starts_host = _check_starts("batched_block_scores", starts, mz.shape[0],
                                device)
    if device.type == "cpu":
        return batched_block_scores_plain(mz, intensity, starts,
                                          fragment_tol, rounds, with_matches)
    layout = _grouped_layout(starts_host)
    n_groups = layout.shape[1] - 1
    n_items, n_pairs = int(layout[0, -1]), int(layout[1, -1])
    lib = _build.library()
    # Pinned, so the copy is queued behind the stream's work instead of
    # waiting for it.
    layout_d = torch.from_numpy(layout).pin_memory().to(device,
                                                        non_blocking=True)
    scores = torch.empty(n_pairs, dtype=torch.float32, device=device)
    matches = (torch.empty(n_pairs, dtype=torch.int32, device=device)
               if with_matches else None)
    sorted_peaks = torch.empty(mz.shape[0] * SORTED_BYTES, dtype=torch.uint8,
                               device=device)
    with torch.cuda.device(device):
        err = lib.falcon_grouped_scores(
            mz.data_ptr(), intensity.data_ptr(), mz.shape[0],
            sorted_peaks.data_ptr(), starts.data_ptr(), layout_d.data_ptr(),
            n_groups, n_items, f32_tolerance(fragment_tol), int(rounds),
            scores.data_ptr(), matches.data_ptr() if with_matches else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check_launch("K4 grouped", err)
    count_launch(batched_block_scores)
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


def _check_ids(ids: torch.Tensor, n_rows: int, n_pool: int,
               device: torch.device) -> None:
    if (ids.dtype != torch.int64 or ids.ndim != 2 or ids.shape[0] != n_rows
            or ids.device != device or not ids.is_contiguous()):
        raise ValueError(f"pair_list_scores: ids must be a contiguous "
                         f"(n_rows={n_rows}, K) int64 tensor on {device}")
    if ids.numel() and int(ids.max()) >= n_pool:
        raise ValueError(f"pair_list_scores: an id is outside the "
                         f"{n_pool}-spectrum pool")


def pair_list_scores(
    mz_q: torch.Tensor,
    int_q: torch.Tensor,
    mz_pool: torch.Tensor,
    int_pool: torch.Tensor,
    ids: torch.Tensor,
    fragment_tol: float,
    rounds: int,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scores of each query row against its own pool ids.

    ``mz_q``/``int_q``: (n_q, P) queries; ``ids``: (n_q, K) int64 rows of
    the (n_pool, P) pool, -1 = none.  Returns (scores f32, matches i32 or
    None), each (n_q, K); an entry with id -1 gets score ``NEG`` and 0
    matches.  On the card one block per query row sorts it once and walks
    only its valid slots; the pool rows must be 16-byte aligned (cp.async).
    """
    device = _check_spectra("pair_list_scores", mz_q, int_q, mz_pool,
                            int_pool)
    if mz_q.shape != int_q.shape or mz_pool.shape != int_pool.shape:
        raise ValueError("pair_list_scores: m/z and intensity shapes differ")
    if rounds < 0:
        raise ValueError(f"pair_list_scores: rounds must be >= 0, got "
                         f"{rounds}")
    _check_ids(ids, mz_q.shape[0], mz_pool.shape[0], device)
    if device.type == "cpu":
        return pair_list_scores_plain(mz_q, int_q, mz_pool, int_pool, ids,
                                      fragment_tol, rounds, with_matches)
    if mz_pool.data_ptr() % 16 or int_pool.data_ptr() % 16:
        raise ValueError("pair_list_scores: the pool must be 16-byte "
                         "aligned on CUDA")
    lib = _build.library()
    scores = torch.empty(ids.shape, dtype=torch.float32, device=device)
    matches = (torch.empty(ids.shape, dtype=torch.int32, device=device)
               if with_matches else None)
    with torch.cuda.device(device):
        err = lib.falcon_pair_list_scores(
            mz_q.data_ptr(), int_q.data_ptr(), mz_q.shape[0],
            mz_pool.data_ptr(), int_pool.data_ptr(), ids.data_ptr(),
            ids.shape[1], f32_tolerance(fragment_tol), int(rounds),
            scores.data_ptr(), matches.data_ptr() if with_matches else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check_launch("pair-list", err)
    count_launch(pair_list_scores)
    return scores, matches


pair_list_scores.launches = 0


def pair_list_scores_plain(
    mz_q: torch.Tensor,
    int_q: torch.Tensor,
    mz_pool: torch.Tensor,
    int_pool: torch.Tensor,
    ids: torch.Tensor,
    fragment_tol: float,
    rounds: int,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`pair_list_scores` (any device)."""
    n_q, k = ids.shape
    flat = ids.reshape(-1)
    keep = torch.nonzero(flat >= 0)[:, 0]
    s, m = indexed_pair_scores(mz_q, int_q, keep // max(k, 1), mz_pool,
                               int_pool, flat[keep], fragment_tol, rounds)
    scores = torch.full((n_q * k,), NEG, device=mz_q.device)
    scores[keep] = s
    if not with_matches:
        return scores.view(n_q, k), None
    matches = torch.zeros(n_q * k, dtype=torch.int32, device=mz_q.device)
    matches[keep] = m
    return scores.view(n_q, k), matches.view(n_q, k)


def _bound_panels(spread: torch.Tensor, plain: torch.Tensor, thr: float,
                  panel: int) -> Iterator[Tuple[int, torch.Tensor,
                                                torch.Tensor]]:
    """(first row, bound, passing mask) per row panel of the (m, m)
    bound matrix ``spread @ plain.T``; a pair passes when it lies above
    the diagonal and its bound reaches ``thr`` (compared in float32)."""
    refuse_tf32("the spread upper bound", spread.device)
    m = spread.shape[0]
    cols = torch.arange(m, device=spread.device)
    plain_t = plain.t()
    thr32 = f32_tolerance(thr)
    for r0 in range(0, m, panel):
        r1 = min(r0 + panel, m)
        ub = spread[r0:r1] @ plain_t
        rows = torch.arange(r0, r1, device=spread.device)
        yield r0, ub, (cols[None, :] > rows[:, None]) & (ub >= thr32)


def ub_pass_counts(spread: torch.Tensor, plain: torch.Tensor, thr: float,
                   panel: int) -> torch.Tensor:
    """Per row, the number of pairs above the diagonal whose spread upper
    bound ``spread_i . plain_j`` reaches ``thr`` (int64, (m,))."""
    counts = torch.empty(spread.shape[0], dtype=torch.int64,
                         device=spread.device)
    for r0, _, ok in _bound_panels(spread, plain, thr, panel):
        counts[r0:r0 + ok.shape[0]] = ok.sum(dim=1)
    return counts


def ub_pass_topk(spread: torch.Tensor, plain: torch.Tensor, thr: float,
                 k: int, panel: int) -> torch.Tensor:
    """Per row, the column ids of the passing pairs, best bound first
    (ties to the lower column), -1 padded to (m, k); ``k`` must cover the
    largest count of :func:`ub_pass_counts`."""
    ids = torch.full((spread.shape[0], k), -1, dtype=torch.int64,
                     device=spread.device)
    thr32 = f32_tolerance(thr)
    for r0, ub, ok in _bound_panels(spread, plain, thr, panel):
        vals, pos = stable_topk(torch.where(ok, ub, -1.0), k)
        ids[r0:r0 + ok.shape[0], :pos.shape[1]] = torch.where(
            vals >= thr32, pos, -1)
    return ids


def pruned_condensed_distances(
    mz: np.ndarray,
    intensity: np.ndarray,
    hasher,
    eps: float,
    fragment_tol: float,
    min_matches: int = 0,
    rounds: int = 4,
    panel_rows: int = 1024,
    device=None,
) -> np.ndarray:
    """Condensed distances with provably unused pairs clamped to 1.0.

    ``falcon_tpu/ops/pairwise.py::pruned_condensed_distances``: a complete
    or single linkage cut at ``eps`` never reads the exact value of a
    distance above ``eps`` (the argument is in that docstring), so only
    the pairs whose tolerance-spread upper bound reaches
    ``1 - eps - 1e-3`` are scored exactly (``pair_list_scores``, at
    ``rounds``), and every other pair gets distance 1.0.  Not valid for
    average linkage.  With ``eps`` near 1 nothing can be pruned, and when
    a row passes more than a quarter of the padded block the component is
    dense; both go to :func:`condensed_distances` (K1) instead.
    ``hasher`` is a ``falcon_tpu_torch.ops.vectorize.SpectrumHasher``.
    """
    n = mz.shape[0]
    if n < 2:
        return np.zeros(0, np.float32)
    thr = 1.0 - float(eps) - 1e-3
    if thr <= 0.0:
        return condensed_distances(mz, intensity, fragment_tol, min_matches,
                                   rounds=DEFAULT_ROUNDS, device=device)
    dev = resolve_device(device)
    m_pad = _pow2_at_least(n, 512)  # the JAX package's block; sets "dense"
    mz_d = torch.from_numpy(np.ascontiguousarray(mz, np.float32)).to(dev)
    int_d = torch.from_numpy(
        np.ascontiguousarray(intensity, np.float32)).to(dev)
    panel = min(panel_rows, m_pad)
    with profiler.phase("bound pairs"):
        plain, spread = hasher.vectorize_pair(mz_d, int_d)
        kmax = int(ub_pass_counts(spread, plain, thr, panel).max())
    out = np.ones(n * (n - 1) // 2, np.float32)
    if kmax == 0:
        return out
    k = _pow2_at_least(kmax, 16)
    if k > m_pad // 4:
        return condensed_distances(mz, intensity, fragment_tol, min_matches,
                                   rounds=DEFAULT_ROUNDS, device=dev)
    with profiler.phase("bound pairs"):
        neigh = ub_pass_topk(spread, plain, thr, k, panel)
    del spread, plain
    # Row chunks bound the (rows, k) score slabs.
    row_chunk = n
    while row_chunk * k > 2**24 and row_chunk > 512:
        row_chunk //= 2
    with_matches = min_matches > 0
    for r0 in range(0, n, row_chunk):
        r1 = min(r0 + row_chunk, n)
        ids = neigh[r0:r1]
        with profiler.phase("score pair lists"):
            scores, matches = pair_list_scores(
                mz_d[r0:r1], int_d[r0:r1], mz_d, int_d, ids, fragment_tol,
                rounds, with_matches)
            valid = (ids >= 0) & (scores > NEG)
            if with_matches:
                # Too few matched peaks means similarity 0, distance 1.0:
                # the clamp already.
                valid &= matches >= min_matches
            ii = torch.arange(r0, r1, device=dev)[:, None].expand_as(
                ids)[valid]
            jj = ids[valid]
            cond = (ii * n - ii * (ii + 1) // 2 + (jj - ii - 1)).cpu()
            dist = (1.0 - scores[valid].clamp(0.0, 1.0)).cpu()
        out[cond.numpy()] = dist.numpy()
    return out
