"""The exact banded top-k (``--ann_index exact``) over a device mesh.

Port of ``falcon_tpu/parallel/sharded_exact_index.py``.  Rows (spectra,
sorted by precursor m/z) shard contiguously, ``local`` rows a shard; each
shard scores its rows against a window of its halo, the peaks, precursor
m/z and RTs of [left neighbour | own | right neighbour] (``sharded_knn.py::
halo``, two ``ppermute``\\ s).  Every row's window starts at the first
COL_TILE-aligned column of its band, relative to the halo, and spans
``window`` columns, the power of two that covers the widest band; a band
that leaves the halo makes the whole search return None, and the caller
takes the one-device exact index.

Scoring is the pair-list kernel against the halo pool (``ops/rerank.py::
rerank_exact(pool=)``), as the JAX package scores with ``rerank_scan_body``
(not its banded panel kernel), and the JAX package's masks follow in its
order:

1. each row's window, scored and sorted by score (a stable sort, ties to
   the lower window position);
2. the precursor band (float32, Da or ppm), not the row itself, a finite
   column m/z and, with ``rt_tol``, the RT tolerance;
3. ``min_matches``: a pair with fewer matched peaks scores 0, after the
   first sort;
4. a second stable top-k of the masked scores.

So zeroed pairs keep the order of the first sort, not their window order.
A pair that step 2 masks can only end as ``NEG`` after the second sort,
and removing it changes no other pair's place in either sort, so the port
drops masked pairs (and the shards' padding rows) before the kernel scores
them: the same lists, for the band's pairs instead of the window's.  The
lists stay on the card, where B.1 reads them.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.exact_knn import COL_TILE
from ..ops.knn import NEG, _pow2_at_least, band_bounds, stable_topk
from ..ops.matching import f32_tolerance
from ..ops.rerank import rerank_exact
from .mesh import Mesh, shard_rows
from .sharded_knn import halo


def _window_starts(band_lo: np.ndarray, band_hi: np.ndarray, n: int,
                   n_dev: int, local: int
                   ) -> Optional[Tuple[np.ndarray, int]]:
    """(each padded row's window start relative to its shard's halo
    [(d-1)*local, (d+2)*local), in COL_TILE units, clamped; the window), or
    None when a band leaves its shard's halo.  The JAX package's rule."""
    tile = COL_TILE
    starts = np.zeros(local * n_dev, np.int32)
    max_span = tile
    for d in range(n_dev):
        halo_lo = (d - 1) * local
        r0, r1 = d * local, min((d + 1) * local, n)
        if r0 >= n:
            starts[d * local:(d + 1) * local] = local // tile
            continue
        lo = (band_lo[r0:r1] // tile) * tile
        hi = np.maximum(band_hi[r0:r1], np.arange(r0, r1) + 1)
        if (lo < halo_lo).any() or (hi > (d + 2) * local).any():
            return None
        max_span = max(max_span, int((hi - lo).max(initial=1)))
        starts[r0:r1] = (lo - halo_lo) // tile
        starts[r1:(d + 1) * local] = local // tile
    window = min(_pow2_at_least(max_span, tile), 3 * local)
    starts = np.minimum(np.maximum(starts, 0), (3 * local - window) // tile)
    return starts, window


def _shard_topk(q_mz, q_int, cols_mz, cols_int, q_pmz, cols_pmz, q_rt,
                cols_rt, q_starts, d, local, n, window, k, tol_mass,
                tol_is_da, rt_tol, fragment_tol, rounds, min_matches):
    """Shard ``d``'s (scores, global ids), each (local, k); ``cols_*`` its
    halo, whose wrapped columns have m/z +inf."""
    dev = q_mz.device
    base = (d - 1) * local  # global row of halo column 0
    cand = (q_starts[:, None].long() * COL_TILE
            + torch.arange(window, device=dev))  # halo columns
    # 2. The masks, on the window's columns before they are scored.
    c_pmz = cols_pmz[cand]
    diff = q_pmz[:, None] - c_pmz
    mass = diff.abs() if tol_is_da else (diff / c_pmz * 1e6).abs()
    q_global = d * local + torch.arange(local, device=dev)
    valid = ((mass <= f32_tolerance(tol_mass))
             & (q_global[:, None] != base + cand)
             & torch.isfinite(c_pmz)
             & (q_global < n)[:, None])
    if rt_tol is not None:
        valid &= ((cols_rt[cand] - q_rt[:, None]).abs()
                  <= f32_tolerance(rt_tol))
    # 1. The first sort, over the window (masked pairs last, as NEG).
    scores, ids, matches = rerank_exact(
        q_mz, q_int, torch.where(valid, cand, -1), fragment_tol, window,
        rounds, pool=(cols_mz, cols_int))
    # 3. min_matches after the first sort, then 4. the second top-k.
    if min_matches > 0:
        scores = torch.where((ids >= 0) & (matches < min_matches), 0.0,
                             scores)
    top, pos = stable_topk(scores, k)
    return top, torch.where(top > NEG, base + torch.gather(ids, 1, pos), -1)


def exact_banded_topk_sharded(
    mz_pad: np.ndarray,
    int_pad: np.ndarray,
    mzs: np.ndarray,
    tol_mass: float,
    tol_mode: str,
    k: int,
    fragment_tol: float,
    mesh: Mesh,
    rounds: int = 4,
    rts: Optional[np.ndarray] = None,
    rt_tol: Optional[float] = None,
    min_matches: int = 0,
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The exact banded top-k with rows sharded over ``mesh``.

    ``mz_pad`` / ``int_pad`` (>= n, P) padded peaks (host), ``mzs`` (n,)
    SORTED precursor m/z, ``rts`` (n,) or None.  Returns (scores float32,
    ids int64), each (n, k), on ``mesh.devices[0]``, ``NEG`` / -1 where a
    row has fewer neighbours (the contract of
    ``falcon_tpu/parallel/sharded_exact_index.py::exact_banded_topk_sharded``,
    whose arrays are on the host), or None when a band leaves the one-shard
    halo."""
    n = len(mzs)
    n_dev = mesh.size
    tol_is_da = tol_mode == "Da"
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_is_da)
    local = _pow2_at_least((n + n_dev - 1) // n_dev, 512)
    n_pad = local * n_dev
    sw = _window_starts(band_lo, band_hi, n, n_dev, local)
    if sw is None:
        return None
    starts, window = sw
    k_eff = int(min(k, window))

    def padded(values, fill, width=None):
        shape = (n_pad,) if width is None else (n_pad, width)
        full = np.full(shape, fill, np.float32)
        full[:n] = values[:n]
        return shard_rows(mesh, torch.from_numpy(full))

    p = mz_pad.shape[1]
    mz_s, int_s = padded(mz_pad, -1e6, p), padded(int_pad, 0.0, p)
    pmz_s = padded(np.asarray(mzs, np.float64), np.inf)
    rt_s = (padded(np.asarray(rts, np.float64), np.inf)
            if rts is not None and rt_tol is not None else None)
    starts_s = shard_rows(mesh, torch.from_numpy(starts))
    cols_mz, cols_int = halo(mesh, mz_s), halo(mesh, int_s)
    cols_pmz = halo(mesh, pmz_s)
    cols_rt = halo(mesh, rt_s) if rt_s is not None else [None] * n_dev
    home = mesh.devices[0]
    out_s, out_i = [], []
    for d in range(n_dev):
        # Wrapped halo columns (shard 0's left, the last shard's right).
        col = (d - 1) * local + torch.arange(3 * local,
                                             device=cols_pmz[d].device)
        c_pmz = torch.where((col >= 0) & (col < n_pad), cols_pmz[d],
                            torch.inf)
        s, i = _shard_topk(
            mz_s[d], int_s[d], cols_mz[d], cols_int[d], pmz_s[d], c_pmz,
            None if rt_s is None else rt_s[d], cols_rt[d], starts_s[d], d,
            local, n, window, k_eff, tol_mass, tol_is_da,
            rt_tol if rt_s is not None else None, fragment_tol, rounds,
            min_matches)
        out_s.append(s.to(home))
        out_i.append(i.to(home))
    scores = torch.cat(out_s)[:n]
    idx = torch.cat(out_i)[:n]
    bad = idx >= n
    scores, idx = torch.where(bad, NEG, scores), torch.where(bad, -1, idx)
    if k_eff < k:
        pad = k - k_eff
        scores = torch.cat([scores, scores.new_full((n, pad), NEG)], dim=1)
        idx = torch.cat([idx, idx.new_full((n, pad), -1)], dim=1)
    return scores, idx
