"""Banded k-NN over a device mesh, with a one-shard halo.

Port of ``falcon_tpu/parallel/sharded_knn.py``.  Spectra are sorted by
precursor m/z, so with rows sharded contiguously every query's tolerance
band lies in its own shard and the two neighbouring ones.  Each shard
receives its neighbours' shards (two ``ppermute``\\ s, ``halo``) and
scores its row blocks against one column window each of
[left | own | right]: the product (TF32 refused), the float32 band test
and the self mask of ``ops/knn.py::knn_banded``, and the per-row
``stable_topk``.  Wrapped halo columns (shard 0's left, shard N-1's right)
get m/z +inf and never pass.  ``_band_windows`` gives each (shard, block)
its window from ``band_bounds``' float32 acceptance region and returns
None when a band is wider than the halo; the caller then takes the
one-device path (and logs it).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.knn import (NEG, _pow2_at_least, band_bounds, refuse_tf32,
                       stable_topk)
from ..ops.matching import f32_tolerance
from .mesh import Mesh, ppermute, shard_rows


def halo(mesh: Mesh, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """[left neighbour's shard | own | right neighbour's shard] on each
    device (edge shards receive the wrapped ones)."""
    n = mesh.size
    from_left = ppermute(mesh, shards, [(i, (i + 1) % n) for i in range(n)])
    from_right = ppermute(mesh, shards, [(i, (i - 1) % n) for i in range(n)])
    return [torch.cat([a, s, b])
            for a, s, b in zip(from_left, shards, from_right)]


def _band_windows(mzs: np.ndarray, tol_mass: float, tol_is_da: bool,
                  n_dev: int, local: int, block_rows: int
                  ) -> Optional[Tuple[np.ndarray, int]]:
    """(window start of each (shard, block) relative to the shard's halo,
    window), or None when a band exceeds the one-shard halo.  A copy of
    ``falcon_tpu/parallel/sharded_pipeline.py::_band_windows``."""
    n = len(mzs)
    # f32-consistent bounds shared with every other kNN path: the device
    # kernel compares f32 m/z, so the halo window must cover its f32
    # acceptance region (ops/knn.band_bounds).
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_is_da)
    n_blocks = local // block_rows
    starts = np.zeros((n_dev, n_blocks), np.int32)
    max_span = block_rows
    for d in range(n_dev):
        halo_lo = (d - 1) * local
        for b in range(n_blocks):
            r0 = d * local + b * block_rows
            if r0 >= n:
                starts[d, b] = local
                continue
            r1 = min(r0 + block_rows, n)
            lo = int(band_lo[r0])
            hi = max(int(band_hi[r1 - 1]), r1)
            if lo < halo_lo or hi > (d + 2) * local:
                return None
            max_span = max(max_span, hi - lo)
            starts[d, b] = lo - halo_lo
    window = min(_pow2_at_least(max_span, block_rows), 3 * local)
    starts = np.minimum(np.maximum(starts, 0), 3 * local - window)
    return starts, window


def local_banded_topk(mesh: Mesh, vectors: Sequence[torch.Tensor],
                      mzs: Sequence[torch.Tensor], starts: np.ndarray,
                      tol_mass: float, k: int, tol_is_da: bool,
                      block_rows: int, window: int
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per shard, (scores, global ids) of each local row's top ``k``
    (``_local_banded_topk``): ``vectors`` (local, D) float32 and ``mzs``
    (local,) float32 shards (padded rows +inf), ``starts`` (n_dev,
    n_blocks) halo-relative window starts.  Missing entries ``NEG`` / -1."""
    cols_all = halo(mesh, vectors)
    col_mz_all = halo(mesh, mzs)
    tol32 = f32_tolerance(tol_mass)
    out_s, out_i = [], []
    for d, (q_all, q_mz_all, cols, col_mz) in enumerate(
            zip(vectors, mzs, cols_all, col_mz_all)):
        dev = q_all.device
        refuse_tf32("knn_banded_sharded", dev)
        local = q_all.shape[0]
        base = (d - 1) * local  # global row of halo column 0
        col_global = base + torch.arange(3 * local, device=dev)
        col_mz = torch.where((col_global >= 0)
                             & (col_global < mesh.size * local), col_mz,
                             torch.inf)
        lane = torch.arange(window, device=dev)
        block_lane = torch.arange(block_rows, device=dev)
        parts_s, parts_i = [], []
        for b in range(local // block_rows):
            r0, c0 = b * block_rows, int(starts[d, b])
            sims = q_all[r0:r0 + block_rows] @ cols[c0:c0 + window].t()
            c_mz = col_mz[c0:c0 + window][None, :]
            diff = q_mz_all[r0:r0 + block_rows, None] - c_mz
            mass = diff.abs() if tol_is_da else (diff / c_mz * 1e6).abs()
            q_global = d * local + r0 + block_lane
            valid = ((mass <= tol32)
                     & (q_global[:, None] != (base + c0 + lane)[None, :])
                     & torch.isfinite(c_mz))
            top, pos = stable_topk(torch.where(valid, sims, NEG), k)
            parts_s.append(top)
            parts_i.append(torch.where(top > NEG, base + c0 + pos, -1))
        out_s.append(torch.cat(parts_s))
        out_i.append(torch.cat(parts_i))
    return out_s, out_i


def knn_banded_sharded(
    vectors: torch.Tensor,
    precursor_mzs: np.ndarray,
    tol_mass: float,
    tol_mode: str,
    k: int,
    mesh: Mesh,
    block_rows: int = 1024,
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Banded k-NN with rows sharded over ``mesh``.

    ``vectors`` (>= n, D) float32, rows in ``precursor_mzs`` order
    (SORTED, (n,)).  Returns (scores float32, ids int64), each (n, k), on
    ``mesh.devices[0]``, with ``NEG`` / -1 for missing neighbours (the
    contract of ``falcon_tpu/parallel/sharded_knn.py::knn_banded_sharded``),
    or None when a band is too wide for a one-shard halo."""
    n = len(precursor_mzs)
    n_dev = mesh.size
    mzs = np.asarray(precursor_mzs, np.float64)
    tol_is_da = tol_mode == "Da"
    local = _pow2_at_least((n + n_dev - 1) // n_dev, 512)
    block_rows = min(block_rows, local)
    bw = _band_windows(mzs, tol_mass, tol_is_da, n_dev, local, block_rows)
    if bw is None:
        return None
    starts, window = bw
    n_pad = local * n_dev
    v_pad = torch.zeros((n_pad, vectors.shape[1]), dtype=torch.float32,
                        device=vectors.device)
    v_pad[:n] = vectors[:n]
    mz_pad = np.full(n_pad, np.inf, np.float32)
    mz_pad[:n] = mzs
    scores, idx = local_banded_topk(
        mesh, shard_rows(mesh, v_pad), shard_rows(mesh, torch.from_numpy(
            mz_pad)), starts, tol_mass, int(min(k, window)), tol_is_da,
        block_rows, window)
    home = mesh.devices[0]
    scores = torch.cat([s.to(home) for s in scores])[:n]
    idx = torch.cat([i.to(home) for i in idx])[:n]
    if scores.shape[1] < k:
        pad = k - scores.shape[1]
        scores = torch.cat([scores, torch.full((n, pad), NEG, device=home)],
                           dim=1)
        idx = torch.cat([idx, torch.full((n, pad), -1, dtype=torch.int64,
                                         device=home)], dim=1)
    bad = idx >= n
    return torch.where(bad, NEG, scores), torch.where(bad, -1, idx)
