"""Peak-matching cosine similarity as plain PyTorch ops.

Port of ``falcon_tpu/ops/matching.py``: the banded intensity-product cost
matrix of two padded spectra, then iterative locally-dominant matching
(every entry that is both its row and its column maximum is selected each
round, ties to the lowest column, then the lowest row).  The algorithm and
its accuracy against the Hungarian optimum are documented there.

This module is the plain version of both CUDA kernels of
``ops/pairwise.py`` and the oracle the tests and ``chip_smoke.py`` hold
them against.  It runs on any device.

``match_score`` adds the selected weights in the order XLA's CPU backend
gives the JAX package's ``match_score``, so scores are bit for bit the
JAX package's and a tie between two duplicate spectra breaks the same way.
Each round's (P, P) selection is cut into 32 x 32 blocks (XLA's reduction
window), and each block is summed from zero in row-major order of the
stored peak positions.  The block sums are then added as LLVM compiles
XLA's loop over them: at P = 64, 128 and 256 it vectorises the loop into
each row of blocks from zero, left to right, then the rows in a halving
tree (``_tree_sum``; at P = 64, (B00 + B01) + (B10 + B11)); at other
widths (P = 192, 512, ...) it adds every block from zero in row-major
order.  The round's total is added to the running score, which is
clipped to [0, 1] once, at the end.  The CUDA kernels
(``csrc/matching.cuh``, P = 64) add in the same order.
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
    """Sum the last axis by repeated halving."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


BLOCK = 32  # XLA's CPU reduction window: the tile is summed in 32 x 32 blocks
# Block rows for which LLVM vectorises XLA's loop over the block sums into
# per-row sums and a halving tree (P = 64, 128, 256); at other widths
# (P = 192, 320, 384, 512 were checked) the loop adds them in order.
VECTORISED_BLOCK_ROWS = (2, 4, 8)


def round_total(selected: torch.Tensor) -> torch.Tensor:
    """The sum of one round's (..., P, P) selection in XLA's CPU order
    (see the module docstring); P a multiple of 32.

    A round selects at most one entry per row, so a row's part of a block
    is that entry or 0, exact in any order, and the block's row-major sum
    is the sum over its rows in ascending order."""
    p = selected.shape[-1]
    if p % BLOCK or selected.shape[-2] != p:
        raise ValueError(f"match_score: the tile must be (P, P) with P a "
                         f"multiple of {BLOCK}, got {tuple(selected.shape)}")
    nb = p // BLOCK
    lead = selected.shape[:-2]
    rows = selected.reshape(lead + (nb, BLOCK, nb, BLOCK)).sum(dim=-1)
    blocks = torch.zeros(lead + (nb, nb), dtype=selected.dtype,
                         device=selected.device)
    for r in range(BLOCK):
        blocks = blocks + rows[..., r, :]
    if nb not in VECTORISED_BLOCK_ROWS:  # the blocks in row-major order
        total = torch.zeros(lead, dtype=selected.dtype,
                            device=selected.device)
        for b in range(nb * nb):
            total = total + blocks[..., b // nb, b % nb]
        return total
    block_rows = torch.zeros(lead + (nb,), dtype=selected.dtype,
                             device=selected.device)
    for bj in range(nb):
        block_rows = block_rows + blocks[..., bj]
    return _tree_sum(block_rows)


def match_score(
    w: torch.Tensor, rounds: int = DEFAULT_ROUNDS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``rounds`` matching rounds on ``w``, stopping early once every
    weight is consumed.  Returns (score clipped to [0, 1], n_matches) over
    the trailing two axes."""
    score = torch.zeros(w.shape[:-2], dtype=w.dtype, device=w.device)
    matches = torch.zeros(w.shape[:-2], dtype=torch.int32, device=w.device)
    r = 0
    while r < rounds and w.numel() and bool(w.max() > 0):
        w, selected, cand = match_rounds_body(w)
        score = score + round_total(selected)
        matches = matches + cand.sum(dim=(-2, -1), dtype=torch.int32)
        r += 1
    return score.clamp(0.0, 1.0), matches


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
