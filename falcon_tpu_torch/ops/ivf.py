"""From-scratch IVF (inverted file) nearest-neighbour index, on PyTorch.

Port of ``falcon_tpu/ops/ivf.py``, the index of ``--ann_index ivf``:

- **Coarse quantizer**: spherical k-means, seeded and deterministic.  The
  assignment is the first maximum of ``V @ C.T`` (a plain ``torch.matmul``
  with TF32 refused, as the JAX package leaves the product to XLA); the
  update (IVF.2, :func:`kmeans_update`, ``csrc/ivf.cu``) puts each list's
  rows in row order with a fill that keeps row order (per-tile counts, a
  ``torch.cumsum``, a warp per tile ranking its rows), then a block per
  list sums its rows in that order, keeps an empty list's old centroid and
  renormalises in ``ops/vectorize.py::normalize_rows``' order: no sort, no
  ``index_add_``, the same bits on every run.  The JAX package sums with a
  one-hot product, whose CPU order is XLA's GEMM's, so centroids agree
  with its to about 1e-7, not bit for bit.
- **Balanced list layout**: the rows' 8 best lists, capacity-capped
  placement and the ``(n_lists, lb, D)`` slab layout (bfloat16 unless
  ``precise``), host code copied verbatim (``_balanced_placement``,
  ``_bucket``, ``IVFIndex._pack_layout``, ``IVFIndex._probe_ids``).
- **Probe scan** (IVF.1, :func:`probe_topk`, ``csrc/ivf.cu``): each query
  slot of a list scores the slab slots of the list's ``n_probe``
  centroid-nearest lists in place, with the precursor-tolerance and
  self-pair mask tested before the dot, and keeps its stable top k in the
  same call (each in-band pair appended as a 64-bit key, then a sort or a
  radix select per row), chunk by chunk as the JAX package's
  ``_chunk_scan``; no per-pair score buffer.  A self-search
  (:meth:`IVFIndex.self_search`) maps slots to rows and rows to row order
  on the device.

The index's build is two phases of ``utils/profiling.py``'s log, ``ivf:
train`` (the training sample, the initial centroids and the k-means steps)
and ``ivf: place`` (the rows' best lists, the balanced placement, the slab
layout and its upload, synchronised while the recorder is on, so that its
span holds the upload); while the recorder is on it counts
``ivf.lists``, ``ivf.cap``, ``ivf.train_rows``, ``ivf.kmeans_steps``,
``ivf.spilled_rows`` (rows placed outside their first list) and, a search,
``ivf.chunks`` (probe-scan launches) and ``ivf.probes`` (query lists times
their probes), and raises the gauge ``ivf.largest_list``; all are known on
the host, so none waits for the card.

The coarse space and the in-scan ranking are the caller's choice
(``coarse_vectors``, ``rank_vectors``); the ann engine picks them by the
JAX package's ``FALCON_TPU_IVF_COARSE`` and ``FALCON_TPU_IVF_RANK``.  The
port always takes the exact top-k: the JAX package's
``FALCON_TPU_IVF_EXACT_TOPK=0`` selects the TPU's ``approx_max_k``, which
is not ported.  The JAX package's chunked host upload
(``device_put_chunked``) is a plain copy to the device here.
"""

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from ..device import resolve_device, synchronize
from ..utils.profiling import profiler
from .knn import NEG, refuse_tf32, stable_topk
from .matching import f32_tolerance
from .medoids import _fma, segment_sums_plain
from .pairwise import _check_launch, count_launch
from .vectorize import normalize_rows

logger = logging.getLogger("falcon_tpu")

ASSIGN_ROWS = 65536  # rows per product of the list assignment
PLAIN_PAIRS = 1 << 20  # unmasked pairs per step of the plain probe scan


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _on(array, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device`` (the same tensor if it is one)."""
    if isinstance(array, torch.Tensor):
        return array.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(array, np.float32)).to(
        device)


MAX_LISTS = 12288  # csrc/ivf.cu: a tile's count of each list in 48 KB
MAX_DIM = 8192  # csrc/ivf.cu: a list's sum in shared memory


def fill_tile(n_lists: int) -> int:
    """Rows per tile of the IVF.2 fill, one warp each: ``n_lists`` (so the
    (n_lists, n_tiles) count table holds about one entry a row), at least
    256 and at most 2,048, a multiple of 32."""
    return min(2048, max(256, -(-n_lists // 32) * 32))


def _check_update(vectors, assign, centroids):
    dev = vectors.device
    if (vectors.dtype != torch.float32 or vectors.ndim != 2
            or not vectors.is_contiguous() or assign.dtype != torch.int32
            or assign.shape != (vectors.shape[0],) or assign.device != dev
            or not assign.is_contiguous() or centroids.dtype != torch.float32
            or centroids.ndim != 2 or centroids.shape[1] != vectors.shape[1]
            or centroids.device != dev):
        raise ValueError("kmeans_update: vectors (rows, dim) and centroids "
                         "(n_lists, dim) must be float32, assign (rows,) "
                         "int32, contiguous, on one device")
    if dev.type == "cuda" and (
            vectors.shape[1] % 4 or vectors.shape[1] > MAX_DIM
            or vectors.data_ptr() % 16 or not centroids.is_contiguous()
            or centroids.data_ptr() % 16
            or centroids.shape[0] > MAX_LISTS):
        raise ValueError(f"kmeans_update: the kernel takes contiguous, "
                         f"16-byte aligned rows of a multiple of 4 "
                         f"dimensions (at most {MAX_DIM}) and at most "
                         f"{MAX_LISTS} lists")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kmeans_update: unsupported device {dev}")


def kmeans_update(vectors: torch.Tensor, assign: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    """The centroids after one Lloyd update (IVF.2): each list's sum of its
    assigned rows (``assign`` in [0, n_lists)), the old centroid where a
    list is empty, renormalised.

    On the card, four calls and no host synchronisation: the per-tile list
    counts, their ``torch.cumsum``, the fill that puts each list's rows in
    ascending row order, and a block per list that sums them in that order
    and renormalises (``csrc/ivf.cu``)."""
    _check_update(vectors, assign, centroids)
    if vectors.device.type == "cpu":
        return kmeans_update_plain(vectors, assign, centroids)
    dev = vectors.device
    (n_lists, dim), n = centroids.shape, vectors.shape[0]
    tile = fill_tile(n_lists)
    n_tiles = -(-n // tile)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        cnt1 = torch.empty(1 + n_lists * n_tiles, dtype=torch.int32,
                           device=dev)
        _check_launch("kmeans_update", lib.falcon_kmeans_count(
            assign.data_ptr(), n, n_lists, tile, cnt1.data_ptr(), stream))
        off = torch.cumsum(cnt1, 0, dtype=torch.int32)
        items = torch.empty(n, dtype=torch.int32, device=dev)
        _check_launch("kmeans_update", lib.falcon_kmeans_fill(
            assign.data_ptr(), n, n_lists, tile, off.data_ptr(),
            items.data_ptr(), stream))
        out = torch.empty_like(centroids)
        _check_launch("kmeans_update", lib.falcon_kmeans_centroids(
            vectors.data_ptr(), dim, items.data_ptr(), off.data_ptr(),
            n_lists, n_tiles, centroids.data_ptr(), out.data_ptr(), stream))
    count_launch(kmeans_update)
    return out


kmeans_update.launches = 0


def kmeans_update_plain(vectors: torch.Tensor, assign: torch.Tensor,
                        centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`kmeans_update` (any device): the
    row-order segment sums of ``ops/medoids.py``, then the same
    renormalisation."""
    n_lists = centroids.shape[0]
    sums = segment_sums_plain(vectors, assign, n_lists)
    counts = torch.bincount(assign.long(), minlength=n_lists)
    return normalize_rows(torch.where(counts[:, None] > 0, sums, centroids))


def _sims(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    refuse_tf32("the IVF quantizer", vectors.device)
    return vectors @ centroids.t()


def _kmeans_step(vectors: torch.Tensor, centroids: torch.Tensor,
                 n_lists: int) -> torch.Tensor:
    """One spherical-k-means Lloyd iteration: each row to its first
    most similar centroid, then :func:`kmeans_update`."""
    assign = torch.argmax(_sims(vectors, centroids), dim=1).int()
    return kmeans_update(vectors, assign, centroids)


def _kmeans_fit(vectors: torch.Tensor, init: torch.Tensor, n_lists: int,
                n_iters: int) -> torch.Tensor:
    """Spherical k-means: ``n_iters`` Lloyd steps from ``init``."""
    centroids = init
    for _ in range(n_iters):
        centroids = _kmeans_step(vectors, centroids, n_lists)
    return centroids


def _assign(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Each row's first most similar centroid, int64."""
    return torch.cat([
        torch.argmax(_sims(vectors[r0:r0 + ASSIGN_ROWS], centroids), dim=1)
        for r0 in range(0, vectors.shape[0], ASSIGN_ROWS)])


def _assign_topk(vectors: torch.Tensor, centroids: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Each row's k centroid choices, best first, ties to the lower list
    (for balanced spill)."""
    return torch.cat([
        stable_topk(_sims(vectors[r0:r0 + ASSIGN_ROWS], centroids), k)[1]
        for r0 in range(0, vectors.shape[0], ASSIGN_ROWS)])


def _balanced_placement(
    choices: np.ndarray, n_lists: int, cap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity-capped list placement, vectorized (no per-row Python
    loop — this sits on the index-build hot path at up to 12.5M rows).

    Rank-by-rank passes: every row first competes (in ascending row
    order) for its best centroid's remaining capacity, unplaced rows
    then compete for their 2nd choice, and so on through the k choices.
    Rows whose every choice is full spill by capacity-only round-robin
    (lists in index order, each taking up to its remaining capacity) —
    such rows lose probe locality, so the spill count is logged as a
    warning (raise n_lists or the choice width if it is large).  Total
    capacity ``n_lists * cap >= 2n`` guarantees the spill always fits.

    Bounds every list at ``cap`` rows, which makes the 3-D slab
    layout's memory DETERMINISTIC (k-means imbalance previously made
    the padded slab width unbounded — a 1M-row corpus OOMed a 16 GB
    chip).  Deterministic given the row order.

    Returns ``(order, counts)``: row indices grouped by list (ascending
    row order within each list) and per-list row counts.
    """
    n, _ = choices.shape
    assigned = np.full(n, -1, np.int64)
    counts = np.zeros(n_lists, np.int64)
    pending = np.arange(n)
    for rank in range(choices.shape[1]):
        if not len(pending):
            break
        want = choices[pending, rank].astype(np.int64)
        by_list = np.argsort(want, kind="stable")
        sw = want[by_list]
        _, start, group_n = np.unique(sw, return_index=True,
                                      return_counts=True)
        # Row's position within its wanted-list group (ascending row
        # order): the first (cap - count) rows of each group fit.
        pos = np.arange(len(sw)) - np.repeat(start, group_n)
        take = pos < (cap - counts[sw])
        assigned[pending[by_list[take]]] = sw[take]
        counts += np.bincount(sw[take], minlength=n_lists)
        pending = pending[assigned[pending] < 0]
    if len(pending):
        logger.warning(
            "IVF balanced placement spilled %d rows whose every "
            "centroid choice was full; spilled rows lose probe "
            "locality (consider more lists)", len(pending),
        )
        slots = np.repeat(np.arange(n_lists), cap - counts)
        spill_to = slots[:len(pending)]
        assigned[pending] = spill_to
        counts += np.bincount(spill_to, minlength=n_lists)
    return np.argsort(assigned, kind="stable"), counts


def _bucket(n: int, minimum: int = 128) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


class IVFIndex:
    """IVF index over L2-normalized vectors with precursor metadata.

    ``vectors`` (n or more rows, D): a tensor (it stays where it is, and
    a later search with this very tensor is a self-search) or an array
    (copied to ``device``, see ``falcon_tpu_torch.device``); only the first
    ``len(precursor_mzs)`` rows are indexed.  ``precise=False`` stores the
    slab layout in bfloat16, ``precise=True`` in float32.
    ``coarse_vectors``: an optional (n, D) L2-normalized embedding used only
    for the quantizer (training, list choices, probe order), not kept past
    ``__init__``.  ``rank_vectors``: an optional (n, D) query-side embedding
    packed into a second slab set; a self-search then scores
    ``rank_q . vectors_c``.  The arguments and their use are the JAX
    package's (``falcon_tpu/ops/ivf.py::IVFIndex``).
    """

    def __init__(
        self,
        vectors,
        precursor_mzs: np.ndarray,
        n_lists: Optional[int] = None,
        n_iters: int = 10,
        seed: int = 42,
        precise: bool = False,
        coarse_vectors=None,
        rank_vectors=None,
        device=None,
    ):
        n = len(precursor_mzs)
        if n_lists is None:
            n_lists = _bucket(max(1, int(np.sqrt(n) + 0.5)), 16)
        # The chunked probe scan takes power-of-two chunks that divide
        # n_lists, so the list count is rounded down to a power of two.
        self.n_lists = 1 << max(0, int(min(n_lists, n)).bit_length() - 1)
        rng = np.random.default_rng(seed)
        dev = (vectors.device if isinstance(vectors, torch.Tensor)
               else resolve_device(device))
        self._device = dev
        vectors_dev = _on(vectors, dev)
        coarse_dev = (vectors_dev if coarse_vectors is None
                      else _on(coarse_vectors, dev))
        self._coarse = coarse_vectors is not None
        with profiler.phase("ivf: train"):
            # The quantizer trains on a power-of-two subsample, as the JAX
            # package's; the initial centroids are rows drawn by NumPy's
            # generator, so both packages start from the same rows.
            sample = min(_bucket(self.n_lists * 128, 1024),
                         _bucket(n, 512))
            train_rows = (np.arange(sample) * max(n // sample, 1)) % n
            init_rows = rng.choice(n, self.n_lists, replace=False)
            train = coarse_dev[
                torch.from_numpy(train_rows).to(dev)].contiguous()
            init = coarse_dev[torch.from_numpy(init_rows).to(dev)]
            centroids_dev = _kmeans_fit(train, init, self.n_lists, n_iters)
            del train, init
            self.centroids = centroids_dev.cpu().numpy()
        profiler.count("ivf.lists", self.n_lists)
        profiler.count("ivf.train_rows", sample)
        profiler.count("ivf.kmeans_steps", n_iters)
        with profiler.phase("ivf: place"):
            choices = _assign_topk(coarse_dev[:n], centroids_dev,
                                   min(8, self.n_lists)).cpu().numpy()
            del coarse_dev  # never resident past init
            # Capacity-capped balanced placement: the cap (2x the mean list
            # size, pow2-bucketed) bounds the slab width, and hence the
            # layout's memory.
            cap = _bucket(2 * max(1, -(-n // self.n_lists)), 128)
            self.order, counts = _balanced_placement(
                choices, self.n_lists, cap)
            self.mzs = np.asarray(precursor_mzs, np.float64)[self.order]
            self.rows = self.order.astype(np.int32)
            self.offsets = np.zeros(self.n_lists + 1, np.int64)
            np.cumsum(counts, out=self.offsets[1:])
            self._max_list = int(counts.max(initial=1))
            self._lb = _bucket(self._max_list, 128)
            idx3d, mz3d, row3d = self._pack_layout(
                self.order, self.mzs, counts, self._lb, n)
            store_dtype = torch.float32 if precise else torch.bfloat16
            idx = torch.from_numpy(idx3d.astype(np.int64)).to(dev)
            mask = torch.from_numpy(
                (mz3d < np.inf).astype(np.float32)).to(dev)
            self._corpus3d = _slabs(vectors_dev, idx, mask, store_dtype)
            self._query3d = None
            if rank_vectors is not None:
                self._query3d = _slabs(_on(rank_vectors, dev), idx, mask,
                                       store_dtype)
            self._mz3d = torch.from_numpy(
                mz3d.reshape(self.n_lists, self._lb)).to(dev)
            self._row3d_host = row3d.reshape(self.n_lists, self._lb)
            self._row3d = torch.from_numpy(self._row3d_host).to(dev)
            # Each row's layout slot, the inverse of the row map: a
            # self-search's lists go to row order by one gather.
            rows_flat = self._row3d_host.reshape(-1)
            slots = np.flatnonzero(rows_flat >= 0)
            slot_of_row = np.empty(n, np.int64)
            slot_of_row[rows_flat[slots]] = slots
            self._slot_of_row = torch.from_numpy(slot_of_row).to(dev)
            if profiler.recording:
                synchronize(dev)
        self._source = vectors_dev  # identity marker for self-search
        self._centroid_sims = self.centroids @ self.centroids.T
        self._probe_cache = {}
        profiler.count("ivf.cap", cap)
        profiler.level("ivf.largest_list", self._max_list)
        if profiler.recording:
            first = choices[self.order, 0]
            placed = np.repeat(np.arange(self.n_lists), counts)
            profiler.count("ivf.spilled_rows", int((placed != first).sum()))

    @staticmethod
    def _pack_layout(order, mzs_sorted, counts, lb, n):
        """Host index/metadata arrays for the (n_lists, lb) layout."""
        n_lists = len(counts)
        idx3d = np.zeros((n_lists, lb), np.int32)
        mz3d = np.full((n_lists, lb), np.inf, np.float32)
        row3d = np.full((n_lists, lb), -1, np.int32)
        offsets = np.zeros(n_lists + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        for lst in range(n_lists):
            c = int(counts[lst])
            lo = int(offsets[lst])
            idx3d[lst, :c] = order[lo:lo + c]
            mz3d[lst, :c] = mzs_sorted[lo:lo + c]
            row3d[lst, :c] = order[lo:lo + c]
        return idx3d.reshape(-1), mz3d, row3d

    def _probe_ids(self, n_probe: int) -> np.ndarray:
        cached = self._probe_cache.get(n_probe)
        if cached is None:
            cached = np.ascontiguousarray(np.argsort(
                -self._centroid_sims, axis=1, kind="stable"
            )[:, :n_probe].astype(np.int32))
            self._probe_cache[n_probe] = cached
        return cached

    def _scan(self, q3d, qmz3d, qrow3d, qlb: int, k: int, n_probe: int,
              tol_mass: float, tol_mode: str, precise: bool):
        """The chunked probe scan of a query layout against the index:
        (n_lists, qlb, k) scores and slots, on the index's device."""
        lb = self._lb
        chunk = scan_chunk(self.n_lists, qlb, n_probe, lb)
        profiler.count("ivf.chunks", self.n_lists // chunk)
        profiler.count("ivf.probes", self.n_lists * n_probe)
        return _chunk_scan(
            q3d, qmz3d, qrow3d, self._corpus3d, self._mz3d, self._row3d,
            torch.from_numpy(self._probe_ids(n_probe)).to(self._device),
            tol_mass, k, tol_mode == "Da", chunk, int(qlb), int(lb),
            int(n_probe), bool(precise))

    def self_search(self, k: int, n_probe: int = 32,
                    tol_mass: float = np.inf, tol_mode: str = "Da",
                    precise: bool = False) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """k-NN of every indexed row among the others (queries == corpus,
        ranked by ``rank_vectors`` where the index has them): (n, k)
        float32 similarities and int32 row ids, tensors on the index's
        device, missing neighbours -2 / -1.  The slots become rows and the
        layout row order by two gathers on the device; nothing is copied
        to the host.  ``precise`` as in :meth:`search`."""
        n_probe = min(n_probe, self.n_lists)
        lb = self._lb
        q3d = self._query3d if self._query3d is not None else self._corpus3d
        k_eff = min(k, n_probe * lb)
        scores, slots = self._scan(q3d, self._mz3d, self._row3d, lb, k_eff,
                                   n_probe, tol_mass, tol_mode, precise)
        rows = torch.where(
            slots >= 0, self._row3d.view(-1)[slots.clamp_min(0).long()], -1)
        out_s = scores.view(-1, k_eff)[self._slot_of_row]
        out_i = rows.view(-1, k_eff)[self._slot_of_row]
        if k_eff < k:
            n = out_s.shape[0]
            out_s = torch.cat([out_s, out_s.new_full((n, k - k_eff), NEG)],
                              dim=1)
            out_i = torch.cat([out_i, out_i.new_full((n, k - k_eff), -1)],
                              dim=1)
        return out_s, out_i

    def search(
        self,
        q_vec,
        q_mz: np.ndarray,
        q_rows: np.ndarray,
        k: int,
        n_probe: int = 32,
        tol_mass: float = np.inf,
        tol_mode: str = "Da",
        precise: bool = False,
        q_coarse=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN of each query; returns (similarities, original row ids),
        NumPy arrays (nq, k).

        Missing neighbors: sim -2, id -1.  ``precise`` scans in float32
        (for runs with no exact rerank, whose eps threshold reads the
        similarities), else in bfloat16 with float32 sums.  ``q_vec`` is
        the index's own ``vectors`` tensor for a self-search (queries ==
        corpus; :meth:`self_search`, copied to the host), else (nq, D)
        query vectors; ``q_coarse``: their coarse-space vectors, for an
        index built with ``coarse_vectors``.
        """
        nq = len(q_mz)
        n_probe = min(n_probe, self.n_lists)
        if q_vec is self._source and nq == len(self.mzs):
            scores, rows = self.self_search(k, n_probe, tol_mass, tol_mode,
                                            precise)
            return scores.cpu().numpy(), rows.cpu().numpy()
        lb = self._lb
        dev = self._device
        q_vec_dev = _on(q_vec, dev)
        if self._coarse and q_coarse is None:
            logger.warning(
                "IVF index built on a coarse embedding but the "
                "query passed none; assigning queries with the "
                "scoring embedding (degraded probe locality)"
            )
        q_assign_src = (q_vec_dev if q_coarse is None
                        else _on(q_coarse, dev))
        q_assign = _assign(
            q_assign_src[:nq],
            torch.from_numpy(self.centroids).to(dev)).cpu().numpy()
        q_order = np.argsort(q_assign, kind="stable")
        q_counts = np.bincount(q_assign, minlength=self.n_lists)
        qlb = _bucket(int(q_counts.max(initial=1)), 128)
        idx3d, qmz3, qrow3 = self._pack_layout(
            q_order,
            np.asarray(q_mz, np.float64)[q_order],
            q_counts, qlb, nq,
        )
        # Query "row ids" in the layout carry the CALLER's row ids
        # (used for self-pair exclusion when queries overlap the
        # corpus by id).
        qrow3 = np.where(
            qrow3 >= 0,
            np.asarray(q_rows, np.int32)[np.clip(qrow3, 0, nq - 1)],
            -2,
        ).astype(np.int32)
        q3d = _slabs(q_vec_dev, torch.from_numpy(
            idx3d.astype(np.int64)).to(dev), torch.from_numpy(
                (qmz3 < np.inf).astype(np.float32)).to(dev),
            torch.float32)
        qmz3d = torch.from_numpy(qmz3.reshape(self.n_lists, qlb)).to(dev)
        qrow3d = torch.from_numpy(qrow3.reshape(self.n_lists, qlb)).to(dev)
        q_slot_pos = np.full(self.n_lists * qlb, -1, np.int64)
        # Map layout slots back to sorted query positions.
        pos = 0
        for lst in range(self.n_lists):
            c = int(q_counts[lst])
            base = lst * qlb
            q_slot_pos[base:base + c] = np.arange(pos, pos + c)
            pos += c

        k_eff = min(k + 1, n_probe * lb)
        scores, slots = self._scan(q3d, qmz3d, qrow3d, qlb, k_eff, n_probe,
                                   tol_mass, tol_mode, precise)
        scores_h = scores.reshape(self.n_lists * qlb, -1).cpu().numpy()
        slots_h = slots.reshape(self.n_lists * qlb, -1).cpu().numpy()
        rows_flat = self._row3d_host.reshape(-1)
        neigh_rows = np.where(
            slots_h >= 0,
            rows_flat[np.clip(slots_h, 0, len(rows_flat) - 1)],
            -1,
        ).astype(np.int32)

        valid = q_slot_pos >= 0
        sorted_scores = np.full((nq, k_eff), float(NEG), np.float32)
        sorted_rows = np.full((nq, k_eff), -1, np.int32)
        sorted_scores[q_slot_pos[valid]] = scores_h[valid]
        sorted_rows[q_slot_pos[valid]] = neigh_rows[valid]
        # Remove self matches by row id, re-compact, trim to k.
        bad = sorted_rows == np.asarray(q_rows, np.int32)[q_order][:, None]
        sorted_scores[bad] = float(NEG)
        sorted_rows[bad] = -1
        order2 = np.argsort(-sorted_scores, axis=1, kind="stable")
        sorted_scores = np.take_along_axis(sorted_scores, order2, 1)
        sorted_rows = np.take_along_axis(sorted_rows, order2, 1)
        k_eff = min(k, k_eff)
        out_scores = np.full((nq, k), float(NEG), np.float32)
        out_idx = np.full((nq, k), -1, np.int32)
        out_scores[q_order, :k_eff] = sorted_scores[:, :k_eff]
        out_idx[q_order, :k_eff] = sorted_rows[:, :k_eff]
        return out_scores, out_idx


def _slabs(source: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """The (n_lists, lb, D) layout of ``source``'s rows ``idx`` (flat, one
    per slot), in ``dtype``, padding slots (``mask`` 0) zero; gathered a
    chunk of lists at a time, so no full-size float32 copy is made."""
    n_lists, lb = mask.shape
    dim = source.shape[1]
    out = torch.empty((n_lists, lb, dim), dtype=dtype, device=source.device)
    lists_per_chunk = max(1, (2 ** 28) // (lb * dim * 4))
    for c0 in range(0, n_lists, lists_per_chunk):
        c1 = min(c0 + lists_per_chunk, n_lists)
        part = source[idx[c0 * lb:c1 * lb]].view(c1 - c0, lb, dim)
        # Padding slots alias row order[0] through index 0; zero them
        # (their m/z is +inf, so they are masked anyway).
        out[c0:c1] = (part * mask[c0:c1, :, None]).to(dtype)
    return out


def _chunk_scan(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d, probe_ids,
                tol_mass: float, k: int, tol_is_da: bool, chunk: int,
                qlb: int, lb: int, n_probe: int, precise: bool = False):
    """Chunked probe scan: per chunk of lists, one :func:`probe_topk` (IVF.1:
    each row's mask, dots and stable top ``k``).  Returns (scores, SLOT ids
    into the flattened (n_lists * lb) layout; -1 missing), each
    (n_lists, qlb, k).

    ``precise=False`` scans bfloat16 operands (exact products, float32
    sums); ``precise=True`` float32 ones."""
    scan_dtype = torch.float32 if precise else torch.bfloat16
    c16 = corpus3d.to(scan_dtype).contiguous()
    q16 = q3d.to(scan_dtype).contiguous()
    n_lists = corpus3d.shape[0]
    tol = f32_tolerance(tol_mass)
    parts = [probe_topk(q16, qmz3d, qrow3d, c16, cmz3d, crow3d, probe_ids,
                        tol, tol_is_da, k, c0, chunk)
             for c0 in range(0, n_lists, chunk)]
    return (torch.cat([s for s, _ in parts]).view(n_lists, qlb, k),
            torch.cat([i for _, i in parts]).view(n_lists, qlb, k))


def scan_chunk(n_lists: int, qlb: int, n_probe: int, lb: int) -> int:
    """Lists per :func:`probe_topk` call: the largest power of two (at most
    ``n_lists``) whose per-row key segments, (chunk * qlb, n_probe * lb)
    64-bit keys, fit in 256 MB, or 1."""
    chunk = 1
    while (chunk * 2 * qlb * n_probe * lb * 8 <= 256 * 2**20
           and chunk * 2 <= n_lists):
        chunk *= 2
    return chunk


def _check_scan(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d, probe_ids, c0,
                chunk):
    dev = corpus3d.device
    n_corpus, lb, dim = corpus3d.shape
    n_lists, qlb = q3d.shape[:2] if q3d.ndim == 3 else (-1, -1)
    for t, dtype, shape, what in (
            (q3d, corpus3d.dtype, (n_lists, qlb, dim), "q3d"),
            (qmz3d, torch.float32, (n_lists, qlb), "qmz3d"),
            (qrow3d, torch.int32, (n_lists, qlb), "qrow3d"),
            (cmz3d, torch.float32, (n_corpus, lb), "cmz3d"),
            (crow3d, torch.int32, (n_corpus, lb), "crow3d"),
            (probe_ids, torch.int32, (n_lists, probe_ids.shape[-1]),
             "probe_ids")):
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"probe_topk: {what} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    if corpus3d.dtype not in (torch.float32, torch.bfloat16) or (
            not corpus3d.is_contiguous()):
        raise ValueError("probe_topk: the slabs must be contiguous float32 "
                         "or bfloat16")
    if not (0 <= c0 and chunk > 0 and c0 + chunk <= n_lists):
        raise ValueError(f"probe_topk: lists [{c0}, {c0 + chunk}) outside "
                         f"[0, {n_lists})")
    if dev.type == "cuda" and dim % 4:
        raise ValueError("probe_topk: the kernel takes a multiple of 4 "
                         "dimensions")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"probe_topk: unsupported device {dev}")


def probe_topk(q3d: torch.Tensor, qmz3d: torch.Tensor, qrow3d: torch.Tensor,
               corpus3d: torch.Tensor, cmz3d: torch.Tensor,
               crow3d: torch.Tensor, probe_ids: torch.Tensor, tol: float,
               tol_is_da: bool, k: int, c0: int,
               chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``k`` best probe pairs of the lists [c0, c0 + chunk)
    (IVF.1): (chunk, qlb, k) float32 scores and int32 slots.

    Row (l - c0, i) scores its pairs at positions p * lb + b, ``q3d[l, i]
    . corpus3d[probe_ids[l, p], b]`` summed in dimension order with one
    fused multiply-add per dimension, or ``NEG`` where the pair is masked
    (a padded query or slab slot, m/z +inf; outside ``tol``, a float32
    value, in Da or ppm; the same row id), and keeps the ``k`` largest,
    ties to the lower position, as ``stable_topk``; a kept pair's slot is
    ``probe_ids[l, p] * lb + b``, -1 where its score is not above ``NEG``.
    In-band scores are taken to lie above ``NEG`` (cosines; dots of
    non-negative vectors).

    ``q3d`` (n_lists, qlb, D) and ``corpus3d`` (n_corpus, lb, D) are both
    float32 or both bfloat16 (widened exactly); ``qmz3d``/``cmz3d``
    float32 and ``qrow3d``/``crow3d`` int32 per slot; ``probe_ids``
    (n_lists, n_probe) int32, lists of ``corpus3d`` (a search's corpus is
    its own queries' lists; a ring step's is one rotating block, whose
    appended list of +inf m/z stands for the probes outside it, see
    ``parallel/sharded_ivf.py``); 1 <= k <= n_probe * lb.  On the card one
    call of ``csrc/ivf.cu`` (a memset and two kernels), which reads the
    probed slabs in place and keeps a segment of (n_probe * lb) 64-bit keys
    per row as scratch, written only for in-band pairs."""
    _check_scan(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d, probe_ids, c0,
                chunk)
    lb, dim = corpus3d.shape[1:]
    qlb, n_probe = q3d.shape[1], probe_ids.shape[1]
    if not 1 <= k <= n_probe * lb:
        raise ValueError(f"probe_topk: k = {k} outside [1, {n_probe * lb}]")
    dev = corpus3d.device
    if dev.type == "cpu":
        return probe_topk_plain(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d,
                                probe_ids, tol, tol_is_da, k, c0, chunk)
    rows = chunk * qlb
    scores = torch.empty((chunk, qlb, k), dtype=torch.float32, device=dev)
    slots = torch.empty((chunk, qlb, k), dtype=torch.int32, device=dev)
    count = torch.empty(rows, dtype=torch.int32, device=dev)
    seg = torch.empty(rows * n_probe * lb, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _check_launch("probe_topk", _build.library().falcon_ivf_probe_topk(
            q3d.data_ptr(), corpus3d.data_ptr(), qmz3d.data_ptr(),
            qrow3d.data_ptr(), cmz3d.data_ptr(), crow3d.data_ptr(),
            probe_ids.data_ptr(), qlb, lb, dim, n_probe, int(c0), int(chunk),
            float(tol), int(bool(tol_is_da)),
            int(corpus3d.dtype == torch.bfloat16), int(k), count.data_ptr(),
            seg.data_ptr(), scores.data_ptr(), slots.data_ptr(),
            _stream(dev)))
    count_launch(probe_topk)
    return scores, slots


probe_topk.launches = 0


def probe_topk_plain(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d, probe_ids,
                     tol: float, tol_is_da: bool, k: int, c0: int,
                     chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`probe_topk` (any device): the whole
    (chunk, qlb, n_probe * lb) score buffer (:func:`probe_scan_plain`), its
    rows' ``stable_topk``, and the slot of each position."""
    lb = corpus3d.shape[1]
    qlb, n_probe = q3d.shape[1], probe_ids.shape[1]
    scores = probe_scan_plain(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d,
                              probe_ids, tol, tol_is_da, c0, chunk)
    top, pos = stable_topk(scores.view(chunk * qlb, n_probe * lb), k)
    probes = probe_ids[c0:c0 + chunk].long().repeat_interleave(qlb, 0)
    slot = torch.gather(probes, 1, pos // lb) * lb + pos % lb
    return (top.view(chunk, qlb, k),
            torch.where(top > NEG, slot, -1).int().view(chunk, qlb, k))


def probe_scan_plain(q3d, qmz3d, qrow3d, corpus3d, cmz3d, crow3d, probe_ids,
                     tol: float, tol_is_da: bool, c0: int,
                     chunk: int) -> torch.Tensor:
    """The (chunk, qlb, n_probe * lb) float32 scores of :func:`probe_topk`
    (any device), entry (l - c0, i, p * lb + b) for the pair at position
    p * lb + b, ``NEG`` where it is masked: the mask of the whole chunk,
    then a gather of the unmasked pairs' operands and the same float32 sum,
    one fused multiply-add per dimension in order
    (``ops/medoids.py::_fma``), ``PLAIN_PAIRS`` pairs at a time."""
    lb = corpus3d.shape[1]
    qlb, n_probe = q3d.shape[1], probe_ids.shape[1]
    probes = probe_ids[c0:c0 + chunk].long()
    qm = qmz3d[c0:c0 + chunk][:, :, None, None]
    sm = cmz3d[probes][:, None]  # (chunk, 1, n_probe, lb)
    diff = qm - sm
    mass = diff.abs() if tol_is_da else (diff / sm * 1e6).abs()
    valid = (torch.isfinite(qm) & torch.isfinite(sm) & (mass <= tol)
             & (qrow3d[c0:c0 + chunk][:, :, None, None]
                != crow3d[probes][:, None]))
    del diff, mass
    out = torch.full((chunk, qlb, n_probe, lb), NEG, dtype=torch.float32,
                     device=corpus3d.device)
    pairs = valid.nonzero()
    for s0 in range(0, pairs.shape[0], PLAIN_PAIRS):
        lst, i, p, b = pairs[s0:s0 + PLAIN_PAIRS].unbind(1)
        a = q3d[c0 + lst, i].float().t().contiguous()
        v = corpus3d[probes[lst, p], b].float().t().contiguous()
        acc = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
        for d in range(a.shape[0]):
            acc = _fma(a[d], v[d], acc)
        out[lst, i, p, b] = acc
    return out.view(chunk, qlb, n_probe * lb)
