"""The ann device chain over a device mesh: vectorize, halo k-NN, exact
rerank, DBSCAN, and the medoid scores.

Port of ``falcon_tpu/parallel/sharded_pipeline.py`` (``ann_cluster_sharded``,
``_band_windows``, ``sharded_medoid_scores``), the same labels.  Rows
(spectra, sorted by precursor m/z) are the shard axis; each shard runs the
port's kernels on its rows:

1. the hashed vectors (``csrc/vectorize.cu``), normalised in the JAX
   package's order (``ops/vectorize.py::normalize_rows``, bit for bit the
   unit vectors of its ``vectorize_body``);
2. the banded top ``k_ann`` of their cosines against a one-shard halo
   (``sharded_knn.py``);
3. with ``rt_tol``, the candidates outside the RT tolerance dropped
   (float32, against a halo of RTs);
4. the exact rerank of the candidates against a halo peak pool (the
   pair-list kernel, queries and pool apart: ``ops/rerank.py::
   rerank_exact(..., pool=...)``) and ``min_matches``;
5. DBSCAN as in ``ops/density.py``: core flags local and all-gathered,
   components by min-label propagation on replicated labels, each shard's
   out-edges and in-edges (grouped by target with a sort and reduced with
   ``segment_reduce``, no scatter) merged across shards with ``pmin``, then
   two pointer jumps, until no label changes; border points join their
   most similar core neighbour.  Only each row's (component, core, border)
   comes to the host, where ``labels_from_parts`` numbers them.

``sharded_medoid_scores`` is the JAX package's medoid score of the sharded
path, ``v_i . s_C`` from the sharded unit vectors: each shard's segment
sums (B.2's group-by and sums kernels, ``ops/medoids.py::segment_sums``,
rows added in ascending order from zero as XLA's scatter-add adds them),
a ``psum`` in mesh order (XLA's CPU all-reduce order), and B.2's row dot
(XLA's dot order): the JAX package's bits.  Padded rows (m/z -1e6,
intensity 0, precursor m/z and RT +inf) add their zero vectors to
segment 0.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import medoids as medoid_ops
from ..ops.density import labels_from_parts
from ..ops.knn import NEG, _pow2_at_least
from ..ops.matching import f32_tolerance
from ..ops.rerank import rerank_exact
from ..ops.vectorize import normalize_rows
from .mesh import Mesh, all_gather, pmin, psum, shard_rows
from .sharded_knn import _band_windows, halo, local_banded_topk

__all__ = ["ann_cluster_sharded", "sharded_medoid_scores", "_band_windows"]


def _rerank_shard(mz, intensity, pool_mz, pool_int, rt, rt_pool, sims,
                  neigh, base, k_final, fragment_tol, rounds, min_matches,
                  rt_tol):
    """Steps 3-4 on one shard: (exact scores, global ids), (local,
    k_final)."""
    local = mz.shape[0]
    if rt_tol is not None:
        pool_idx = (neigh - base).clamp(0, 3 * local - 1)
        bad = (neigh >= 0) & ((rt_pool[pool_idx] - rt[:, None]).abs()
                              > f32_tolerance(rt_tol))
        sims = torch.where(bad, NEG, sims)
        neigh = torch.where(bad, -1, neigh)
    pool_ids = torch.where(neigh >= 0, neigh - base, -1)
    scores, ids, n_match = rerank_exact(mz, intensity, pool_ids,
                                        fragment_tol, k_final, rounds,
                                        pool=(pool_mz, pool_int))
    ids = torch.where(ids >= 0, ids + base, -1)
    if min_matches > 0:
        scores = torch.where((ids >= 0) & (n_match < min_matches), 0.0,
                             scores)
    return scores, ids


def _in_edges(edge: torch.Tensor, neigh_safe: torch.Tensor, n_pad: int):
    """A shard's edges grouped by target: (local source row of each,
    in-degree of each of the ``n_pad`` rows)."""
    k = edge.shape[1]
    target, order = torch.sort(torch.where(edge, neigh_safe, n_pad)
                               .reshape(-1))
    off = torch.searchsorted(target, torch.arange(n_pad + 1,
                                                  device=edge.device))
    return order[:int(off[-1])] // k, off[1:] - off[:-1]


def _components(mesh: Mesh, within, core_local, core_full, ids, n_pad):
    """Step 5's label propagation: per shard, the component label (the
    smallest row id of its component) of each core row, -1 elsewhere."""
    shards = []
    for d, (w, c, cf, g) in enumerate(zip(within, core_local, core_full,
                                          ids)):
        local = w.shape[0]
        row = d * local + torch.arange(local, device=w.device)
        neigh_safe = g.clamp(0, n_pad - 1)
        edge = w & c[:, None] & cf[neigh_safe]
        src, in_degree = _in_edges(edge, neigh_safe, n_pad)
        shards.append((row, neigh_safe, edge, src, in_degree))
    labels = [torch.where(cf, torch.arange(n_pad, device=cf.device), n_pad)
              for cf in core_full]
    for _ in range(n_pad):
        contrib = []
        for lab, (row, neigh_safe, edge, src, in_degree) in zip(labels,
                                                                 shards):
            own = lab[row]
            # Out-edges: the smallest neighbour label onto own rows.
            new = torch.full((n_pad,), n_pad, dtype=lab.dtype,
                             device=lab.device)
            new[row] = torch.minimum(own, torch.where(
                edge, lab[neigh_safe], n_pad).amin(dim=1))
            # In-edges: the smallest own label among this shard's rows
            # that list a row (labels are row ids, exact in float64).
            if src.numel():
                incoming = torch.segment_reduce(
                    own[src].double(), "min", lengths=in_degree,
                    unsafe=True, initial=float(n_pad))
                new = torch.minimum(new, incoming.long())
            contrib.append(new)
        merged = pmin(mesh, contrib)
        changed = False
        for i, (lab, new) in enumerate(zip(labels, merged)):
            new = torch.minimum(new, lab)
            # Pointer jumping on the replicated labels: label[label[x]]
            # is in x's component too.
            new = torch.minimum(new, new[new.clamp_max(n_pad - 1)])
            new = torch.minimum(new, new[new.clamp_max(n_pad - 1)])
            if i == 0:
                changed = bool((new != lab).any())
            merged[i] = new
        labels = merged
        if not changed:
            break
    return [torch.where(c, lab[row], -1) for c, lab, (row, *_) in
            zip(core_local, labels, shards)]


def ann_cluster_sharded(
    mz_pad: np.ndarray,
    int_pad: np.ndarray,
    precursor_mzs: np.ndarray,
    rts: Optional[np.ndarray],
    hasher,
    tol_mass: float,
    tol_mode: str,
    k_ann: int,
    k_final: int,
    fragment_tol: float,
    eps: float,
    min_samples: int,
    min_matches: int,
    rt_tol: Optional[float],
    mesh: Mesh,
    block_rows: int = 1024,
    rounds: int = 4,
) -> Optional[Tuple[np.ndarray, List[torch.Tensor], int]]:
    """Run the sharded chain; returns (labels, vector shards, n_pad), or
    None when a precursor band is wider than a one-shard halo.

    ``mz_pad`` / ``int_pad`` (n, P) padded peaks and ``precursor_mzs``
    (n,), SORTED by precursor m/z; ``rts`` (n,) or None; ``hasher`` a
    ``falcon_tpu_torch.ops.vectorize.SpectrumHasher``.  ``labels``: DBSCAN
    labels (n,), -1 noise, numbered by first occurrence (``ops/density.py::
    dbscan``'s contract); the vector shards (local, D) feed
    :func:`sharded_medoid_scores`."""
    n, p = mz_pad.shape
    n_dev = mesh.size
    mzs = np.asarray(precursor_mzs, np.float64)
    tol_is_da = tol_mode == "Da"
    local = _pow2_at_least((n + n_dev - 1) // n_dev, 512)
    n_pad = local * n_dev
    block_rows = min(block_rows, local)
    bw = _band_windows(mzs, tol_mass, tol_is_da, n_dev, local, block_rows)
    if bw is None:
        return None
    starts, window = bw
    k_ann = min(k_ann, window)
    k_final = min(k_final, k_ann)

    def padded(values, fill, width=None):
        shape = (n_pad,) if width is None else (n_pad, width)
        full = np.full(shape, fill, np.float32)
        full[:n] = values
        return shard_rows(mesh, torch.from_numpy(full))

    mz_s, int_s = padded(mz_pad, -1e6, p), padded(int_pad, 0.0, p)
    pmz_s = padded(mzs, np.inf)
    rt_s = padded(rts, np.inf) if rt_tol is not None else None

    # 1. Vectorize locally.
    vectors = [normalize_rows(hasher.vectorize(m, i, norm=False))
               for m, i in zip(mz_s, int_s)]
    # 2. Banded k-NN against the halo of vectors and m/z.
    sims, neigh = local_banded_topk(mesh, vectors, pmz_s, starts, tol_mass,
                                    k_ann, tol_is_da, block_rows, window)
    # 3-4. RT filter and exact rerank against the halo peak pool.
    pool_mz, pool_int = halo(mesh, mz_s), halo(mesh, int_s)
    rt_pool = halo(mesh, rt_s) if rt_s is not None else [None] * n_dev
    scores, ids = [], []
    for d in range(n_dev):
        s, g = _rerank_shard(
            mz_s[d], int_s[d], pool_mz[d], pool_int[d],
            None if rt_s is None else rt_s[d], rt_pool[d], sims[d],
            neigh[d], (d - 1) * local, k_final, fragment_tol, rounds,
            min_matches, rt_tol)
        scores.append(s)
        ids.append(g)
    del sims, neigh, pool_mz, pool_int, rt_pool

    # 5. DBSCAN: core flags local, then all-gathered.
    eps32 = f32_tolerance(eps)
    within, core_local, in_range = [], [], []
    for d, (s, g) in enumerate(zip(scores, ids)):
        r = (d * local + torch.arange(local, device=s.device)) < n
        w = (g >= 0) & r[:, None] & ((1.0 - s) <= eps32)
        within.append(w)
        core_local.append(((w.sum(dim=1) + 1) >= min_samples) & r)
        in_range.append(r)
    core_full = all_gather(mesh, core_local)
    comp = _components(mesh, within, core_local, core_full, ids, n_pad)
    border = []
    for w, c, cf, s, g, r in zip(within, core_local, core_full, scores,
                                 ids, in_range):
        # Border points: the most similar core neighbour within eps.
        core_neigh = w & cf[g.clamp(0, n_pad - 1)]
        best = torch.argmax(torch.where(core_neigh, s, NEG), dim=1)
        best_id = torch.gather(g, 1, best[:, None])[:, 0]
        border.append(torch.where(core_neigh.any(dim=1) & ~c & r, best_id,
                                  -1))

    def host(parts):
        return torch.cat([t.cpu() for t in parts])[:n].numpy()

    labels = labels_from_parts(host(comp), host(core_local), host(border), n)
    return labels, vectors, n_pad


def sharded_medoid_scores(vectors: Sequence[torch.Tensor], seg: np.ndarray,
                          n_seg: int, mesh: Mesh) -> np.ndarray:
    """Per-row medoid scores ``v_i . sum_{segment(i)} v_j`` over the mesh
    (numpy float32, (n,)), ``seg`` (n,) the segment of each row: per-shard
    segment sums, a ``psum`` in mesh order, then each row's dot with its
    segment's sum."""
    n = len(seg)
    n_seg_pad = _pow2_at_least(n_seg, 256)
    n_pad = sum(v.shape[0] for v in vectors)
    seg_full = np.zeros(n_pad, np.int32)
    seg_full[:n] = seg
    seg_s = shard_rows(mesh, torch.from_numpy(seg_full))
    # No row is in segment n_seg_pad: nothing is dropped as noise.
    sums = psum(mesh, [medoid_ops.segment_sums(v, s, n_seg_pad)
                       for v, s in zip(vectors, seg_s)])
    out = [medoid_ops.segment_dots(v, s, t, n_seg_pad)
           for v, s, t in zip(vectors, seg_s, sums)]
    return torch.cat([o.cpu() for o in out])[:n].numpy()
