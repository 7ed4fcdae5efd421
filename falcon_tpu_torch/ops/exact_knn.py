"""Exact banded k-NN: the peak-matching cosine over the precursor band.

Port of ``falcon_tpu/ops/exact_knn.py`` (``--ann_index exact``): every
in-band pair is scored with the exact locally-dominant matching cosine and
each row keeps its top k, so there is no hash in the loop and recall@k
against the exact cosine is 1.0 by construction.

Spectra are sorted by precursor m/z, so row i's candidates are a contiguous
run of columns.  ``window_layout`` gives each row a start, in 128-column
tiles, and one power-of-two window that covers the widest band.
``banded_panel_scores`` (K2) scores a block of rows against their windows;
it replaces the Pallas kernel ``_banded_panel_pallas``, which reads the
column tiles through a scalar-prefetched index map.  ``exact_banded_topk``
streams row blocks and column passes through K2, masks each pass
(``topk_postlude``) and merges the passes' top-k.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import synchronize
from ..utils.profiling import profiler
from . import _build
from .knn import NEG, _pow2_at_least, band_bounds, merge_topk, stable_topk
from .matching import f32_tolerance, indexed_pair_scores
from .pairwise import _check_launch, _check_spectra, count_launch

COL_TILE = 128
DEFAULT_BLOCK_ROWS = 4096
# Bytes of one pass's float32 score panel (block_rows x pass width).  The
# JAX package holds 128 MiB on a 16 GB TPU; on the H100's 80 GB a pass of
# 4096 rows may be 32,768 columns wide.  The sort of the postlude takes
# about three times the panel again.
PANEL_BYTES = 512 * 2**20
_MAX_ROWS = 65535  # K2's grid y limit


def window_layout(
    mzs: np.ndarray, tol_mass: float, tol_mode: str, n_pad: int,
    tile: int = COL_TILE,
) -> Tuple[np.ndarray, int]:
    """Per-row column-window starts (int32, in tiles, ``n_pad`` of them)
    and the window width, as ``falcon_tpu/ops/exact_knn.py``.

    ``mzs``: (n,) SORTED precursor m/z.  The window is the tile-aligned
    power-of-two envelope of the widest band; padded rows start at 0, and
    every start is clamped so its window ends inside ``n_pad``.
    """
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_mode == "Da")
    starts = (band_lo // tile).astype(np.int32)
    span = int((band_hi - starts * tile).max(initial=1))
    window = min(_pow2_at_least(span, tile), n_pad)
    starts = np.concatenate([starts, np.zeros(n_pad - len(mzs), np.int32)])
    return np.minimum(starts, (n_pad - window) // tile), window


def _check_starts(starts: torch.Tensor, n_rows: int, n_pool: int,
                  pass_offset: int, window: int,
                  device: torch.device) -> None:
    if (starts.dtype != torch.int32 or starts.shape != (n_rows,)
            or starts.device != device or not starts.is_contiguous()):
        raise ValueError(f"banded_panel_scores: starts must be a contiguous "
                         f"int32 tensor of {n_rows} tile starts on {device}")
    if n_rows:
        lo, hi = (int(v) for v in torch.aminmax(starts))
        if lo * COL_TILE + pass_offset < 0 or (
                hi * COL_TILE + pass_offset + window > n_pool):
            raise ValueError("banded_panel_scores: a row's window leaves "
                             f"the {n_pool}-spectrum pool")


def banded_panel_scores(
    mz_rows: torch.Tensor,
    int_rows: torch.Tensor,
    mz_pool: torch.Tensor,
    int_pool: torch.Tensor,
    starts: torch.Tensor,
    pass_offset: int,
    window: int,
    fragment_tol: float,
    rounds: int,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scores of each row against its column window (K2).

    Row i of ``mz_rows``/``int_rows`` (n_rows, P) is scored against pool
    spectra ``starts[i] * 128 + pass_offset + c`` for c < ``window``.
    Returns (scores f32, matches i32 or None), each (n_rows, window),
    scores clipped to [0, 1].
    """
    device = _check_spectra("banded_panel_scores", mz_rows, int_rows,
                            mz_pool, int_pool)
    if mz_rows.shape != int_rows.shape or mz_pool.shape != int_pool.shape:
        raise ValueError("banded_panel_scores: m/z and intensity shapes "
                         "differ")
    if rounds < 0 or window < 0:
        raise ValueError("banded_panel_scores: rounds and window must be "
                         ">= 0")
    n_rows = mz_rows.shape[0]
    _check_starts(starts, n_rows, mz_pool.shape[0], pass_offset, window,
                  device)
    if device.type == "cpu":
        return banded_panel_scores_plain(
            mz_rows, int_rows, mz_pool, int_pool, starts, pass_offset,
            window, fragment_tol, rounds, with_matches)
    if n_rows > _MAX_ROWS:
        raise ValueError(f"banded_panel_scores: at most {_MAX_ROWS} rows "
                         f"per launch, got {n_rows}")
    lib = _build.library()
    scores = torch.empty((n_rows, window), dtype=torch.float32,
                         device=device)
    matches = (torch.empty((n_rows, window), dtype=torch.int32,
                           device=device) if with_matches else None)
    with torch.cuda.device(device):
        err = lib.falcon_banded_scores(
            mz_rows.data_ptr(), int_rows.data_ptr(), n_rows,
            mz_pool.data_ptr(), int_pool.data_ptr(), starts.data_ptr(),
            int(pass_offset), int(window), f32_tolerance(fragment_tol),
            int(rounds), scores.data_ptr(),
            matches.data_ptr() if with_matches else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check_launch("K2 banded", err)
    count_launch(banded_panel_scores)
    return scores, matches


banded_panel_scores.launches = 0


def banded_panel_scores_plain(
    mz_rows: torch.Tensor,
    int_rows: torch.Tensor,
    mz_pool: torch.Tensor,
    int_pool: torch.Tensor,
    starts: torch.Tensor,
    pass_offset: int,
    window: int,
    fragment_tol: float,
    rounds: int,
    with_matches: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`banded_panel_scores` (any
    device)."""
    n_rows = mz_rows.shape[0]
    cols = (starts.to(torch.int64)[:, None] * COL_TILE + int(pass_offset)
            + torch.arange(window, device=mz_rows.device))
    rows = torch.arange(n_rows, device=mz_rows.device).repeat_interleave(
        window)
    s, m = indexed_pair_scores(mz_rows, int_rows, rows, mz_pool, int_pool,
                               cols.reshape(-1), fragment_tol, rounds)
    return (s.view(n_rows, window),
            m.view(n_rows, window) if with_matches else None)


def topk_postlude(
    scores: torch.Tensor,
    matches: Optional[torch.Tensor],
    col_ids: torch.Tensor,
    mz_meta: torch.Tensor,
    rt_meta: Optional[torch.Tensor],
    tol_mass: float,
    tol_is_da: bool,
    rt_tol: Optional[float],
    n: int,
    min_matches: int,
    row_offset: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask one pass's (rows, w) scores and keep each row's top ``k``.

    As ``falcon_tpu/ops/exact_knn.py::_topk_postlude``: a score with fewer
    than ``min_matches`` matched peaks becomes 0.0; then only pairs within
    the precursor tolerance (float32, ppm as ``|diff / c_mz * 1e6|``),
    off the diagonal, with a finite column m/z, a real row and, with
    ``rt_tol``, within the RT tolerance keep their score, the rest get
    ``NEG``.  ``col_ids`` (rows, w) are the columns' global ids;
    ``mz_meta``/``rt_meta`` are float32 per padded row, +inf on padding.
    Returns (scores, column ids or -1), each (rows, k), ordered as
    ``lax.top_k`` orders them.
    """
    n_rows = scores.shape[0]
    n_pad = mz_meta.shape[0]
    row = row_offset + torch.arange(n_rows, device=scores.device)
    col_safe = col_ids.clamp(0, n_pad - 1)
    c_mz = mz_meta[col_safe]
    diff = mz_meta[row][:, None] - c_mz
    mass_diff = diff.abs() if tol_is_da else (diff / c_mz * 1e6).abs()
    valid = ((mass_diff <= f32_tolerance(tol_mass))
             & (row[:, None] != col_ids)
             & torch.isfinite(c_mz)
             & (row < n)[:, None])
    if rt_tol is not None:
        valid &= ((rt_meta[col_safe] - rt_meta[row][:, None]).abs()
                  <= f32_tolerance(rt_tol))
    if min_matches > 0:
        scores = torch.where(matches >= min_matches, scores, 0.0)
    top, pos = stable_topk(torch.where(valid, scores, NEG), k)
    ids = torch.where(top > NEG, torch.gather(col_ids, 1, pos), -1)
    return top, ids


def exact_banded_topk(
    mz_pad: torch.Tensor,    # (n_pad, P) padded peak m/z
    int_pad: torch.Tensor,   # (n_pad, P) L2-normalised intensities
    mzs: np.ndarray,         # (n,) SORTED precursor m/z
    tol_mass: float,
    tol_mode: str,
    k: int,
    fragment_tol: float,
    rounds: int = 4,
    rts: Optional[np.ndarray] = None,
    rt_tol: Optional[float] = None,
    min_matches: int = 0,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    pass_width: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k neighbours within the precursor band.

    Returns (similarities f32, neighbour ids int64 or -1), each
    (n_pad, min(k, window)), on the peaks' device.  Rows stream in blocks
    of ``block_rows``; each block's window is covered by column passes of
    ``pass_width`` columns (default: the widest power-of-two share of the
    window whose score panel fits ``PANEL_BYTES``), and the passes' top-k
    merge with the earlier pass winning ties, so the result does not
    depend on either size.  Padded rows (n and on) are not scored: their
    lists are empty (``NEG`` / -1), as the JAX package's are.
    """
    device = mz_pad.device
    n = len(mzs)
    n_pad = mz_pad.shape[0]
    starts, window = window_layout(mzs, tol_mass, tol_mode, n_pad)
    k = int(min(k, window))
    block_rows = min(n_pad, int(block_rows))
    floor = _pow2_at_least(k, COL_TILE)
    if pass_width is None:
        pass_width = window
        while (block_rows * pass_width * 4 > PANEL_BYTES
               and pass_width // 2 >= floor):
            pass_width //= 2
    else:
        pass_width = min(window, _pow2_at_least(max(int(pass_width), k),
                                                COL_TILE))
    n_passes = window // pass_width
    with_matches = min_matches > 0

    mz_host = np.full(n_pad, np.inf, np.float32)
    mz_host[:n] = mzs
    mz_meta = torch.from_numpy(mz_host).to(device)
    rt_meta = None
    if rts is not None and rt_tol is not None:
        rt_host = np.full(n_pad, np.inf, np.float32)
        rt_host[:n] = rts
        rt_meta = torch.from_numpy(rt_host).to(device)
    else:
        rt_tol = None
    starts_dev = torch.from_numpy(starts).to(device)
    lane = torch.arange(pass_width, device=device)

    parts_s, parts_i = [], []
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        st_block = starts_dev[r0:r1]
        acc_s = acc_i = None
        for p in range(n_passes):
            offset = p * pass_width
            with profiler.phase("score band (K2)"):
                scores, matches = banded_panel_scores(
                    mz_pad[r0:r1], int_pad[r0:r1], mz_pad, int_pad,
                    st_block, offset, pass_width, fragment_tol, rounds,
                    with_matches)
                synchronize(device)
            col_ids = (st_block.to(torch.int64)[:, None] * COL_TILE
                       + offset + lane)
            s_p, i_p = topk_postlude(
                scores, matches, col_ids, mz_meta, rt_meta, tol_mass,
                tol_mode == "Da", rt_tol, n, min_matches, r0, k)
            if acc_s is None:
                acc_s, acc_i = s_p, i_p
            else:
                acc_s, acc_i = merge_topk(acc_s, acc_i, s_p, i_p, k)
        parts_s.append(acc_s)
        parts_i.append(acc_i)
    # Rows from n on are padding: the postlude would mask every pair of
    # theirs, so they are not scored.
    parts_s.append(torch.full((n_pad - n, k), NEG, device=device))
    parts_i.append(torch.full((n_pad - n, k), -1, dtype=torch.int64,
                              device=device))
    return torch.cat(parts_s), torch.cat(parts_i)
