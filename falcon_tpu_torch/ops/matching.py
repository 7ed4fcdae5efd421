"""Peak-matching cosine similarity as plain PyTorch ops.

Port of ``falcon_tpu/ops/matching.py``: the banded intensity-product cost
matrix of two padded spectra, then iterative locally-dominant matching
(every entry that is both its row and its column maximum is selected each
round, ties to the lowest column, then the lowest row).  The algorithm and
its accuracy against the Hungarian optimum are documented there.

This module is the plain version of both CUDA kernels of
``ops/pairwise.py`` and the oracle the tests and ``chip_smoke.py`` hold
them against.  It runs on any device.

One deliberate detail: ``match_score`` sums the selected weights per
column first (a column is selected at most once over all rounds, so this is
exact) and then adds the columns in a fixed halving tree.  That is the
order the CUDA kernel adds them in (one value per column, two columns per
lane, then a butterfly over the warp), so kernel and plain version agree
bit for bit; against the JAX package they agree to float rounding.
"""

from typing import Tuple

import numpy as np
import torch

DEFAULT_ROUNDS = 8


def _first_true(mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Keep only the first True along ``axis`` (an iota min-reduction)."""
    axis = axis % mask.ndim
    n = mask.shape[axis]
    shape = [1] * mask.ndim
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    first = torch.where(mask, idx, n).amin(dim=axis, keepdim=True)
    return mask & (idx == first)


def match_rounds_body(
    w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One locally-dominant matching round on (..., P, P) weights.

    Returns (new_w, selected, cand): the surviving weights, the selected
    weights (zero where unselected) and the boolean selection mask.
    """
    row_max = w.amax(dim=-1, keepdim=True)
    col_max = w.amax(dim=-2, keepdim=True)
    cand = (w == row_max) & (w == col_max) & (w > 0)
    cand = _first_true(cand, axis=-1)
    cand = _first_true(cand, axis=-2)
    selected = torch.where(cand, w, 0.0)
    row_hit = cand.any(dim=-1, keepdim=True)
    col_hit = cand.any(dim=-2, keepdim=True)
    new_w = torch.where(row_hit | col_hit, 0.0, w)
    return new_w, selected, cand


def f32_tolerance(fragment_tol: float) -> float:
    """``fragment_tol`` rounded to float32, as JAX rounds a weakly typed
    Python float compared with a float32 array."""
    return float(np.float32(fragment_tol))


def pair_weights(
    mz_a: torch.Tensor,
    int_a: torch.Tensor,
    mz_b: torch.Tensor,
    int_b: torch.Tensor,
    fragment_tol: float,
) -> torch.Tensor:
    """w[p, q] = int_a[p] * int_b[q] where |mz_a[p] - mz_b[q]| <= tol,
    else 0; all in float32."""
    within = (
        (mz_a[..., :, None] - mz_b[..., None, :]).abs()
        <= f32_tolerance(fragment_tol)
    )
    return torch.where(within, int_a[..., :, None] * int_b[..., None, :], 0.0)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis by repeated halving (the kernel's order)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def match_score(
    w: torch.Tensor, rounds: int = DEFAULT_ROUNDS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``rounds`` matching rounds on ``w``, stopping early once every
    weight is consumed.  Returns (score clipped to [0, 1], n_matches) over
    the trailing two axes."""
    col_score = torch.zeros(w.shape[:-2] + w.shape[-1:], dtype=w.dtype,
                            device=w.device)
    matches = torch.zeros(w.shape[:-2], dtype=torch.int32, device=w.device)
    r = 0
    while r < rounds and w.numel() and bool(w.max() > 0):
        w, selected, cand = match_rounds_body(w)
        col_score = col_score + selected.sum(dim=-2)
        matches = matches + cand.sum(dim=(-2, -1), dtype=torch.int32)
        r += 1
    return _tree_sum(col_score).clamp(0.0, 1.0), matches


def pair_scores(
    mz_a: torch.Tensor,
    int_a: torch.Tensor,
    mz_b: torch.Tensor,
    int_b: torch.Tensor,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, n_matches) for a batch of spectrum pairs given as (..., P)
    padded arrays."""
    w = pair_weights(mz_a, int_a, mz_b, int_b, fragment_tol)
    return match_score(w, rounds)


def indexed_pair_scores(
    mz_a: torch.Tensor,
    int_a: torch.Tensor,
    idx_a: torch.Tensor,
    mz_b: torch.Tensor,
    int_b: torch.Tensor,
    idx_b: torch.Tensor,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    pair_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores of the pairs (mz_a[idx_a[t]], mz_b[idx_b[t]]), computed in
    chunks of ``pair_chunk`` pairs so the (chunk, P, P) weights stay
    bounded.  Returns (scores f32, matches i32), one per pair."""
    n = idx_a.shape[0]
    scores = torch.zeros(n, dtype=torch.float32, device=mz_a.device)
    matches = torch.zeros(n, dtype=torch.int32, device=mz_a.device)
    for t0 in range(0, n, pair_chunk):
        ia = idx_a[t0:t0 + pair_chunk]
        ib = idx_b[t0:t0 + pair_chunk]
        s, m = pair_scores(mz_a[ia], int_a[ia], mz_b[ib], int_b[ib],
                           fragment_tol, rounds)
        scores[t0:t0 + pair_chunk] = s
        matches[t0:t0 + pair_chunk] = m
    return scores, matches


def block_scores(
    mz: torch.Tensor,
    intensity: torch.Tensor,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    pair_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs (n, n) score / match-count matrices of one block
    (counterpart of ``block_scores_xla``)."""
    n = mz.shape[0]
    flat = torch.arange(n * n, device=mz.device)
    ii, jj = flat // n, flat % n
    scores, matches = indexed_pair_scores(
        mz, intensity, ii, mz, intensity, jj, fragment_tol, rounds,
        pair_chunk,
    )
    return scores.view(n, n), matches.view(n, n)
