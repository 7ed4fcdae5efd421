"""Medoid scores of the ann engine's dbscan mode: two CUDA kernels and their
plain versions.

A cluster's medoid is the member with the largest score (the first such
row).  Two scores, as in ``falcon_tpu/cluster/ann_engine.py``:

- ``sparse_medoid_scores`` (``_sparse_exact_medoid_scores``, :180-260),
  when the lists hold exact similarities (``--rerank exact`` or
  ``--ann_index exact``): per row, the sum of ``max(s, 0)`` over its
  same-cluster neighbours in the sparse lists, each unordered pair counted
  once (an edge ``a -> b`` counts when ``a < b`` or when ``b``'s list does
  not hold ``a``) and added to both ends;
- ``hashed_medoid_scores`` (``_medoid_scores``, :138-174), under
  ``--rerank off``: ``v_i . s_C`` with ``s_C`` the sum of the normalised
  vectors of row ``i``'s cluster.

The JAX package computes both with XLA scatter-adds, which on the CPU add
one update after another in index order.  The plain versions here take
every sum in XLA's CPU order (its row sums in windows of 32; its dot the
first 8 products rounded and added, then one fused multiply-add per
dimension), and the kernels (``csrc/medoids.cu``) take the plain versions'
order, so the three agree bit for bit; an atomic
scatter on the card would not, and one ulp can move the medoid of tied
(duplicate) spectra.  The sparse scores put each target's weights in
(row, slot) order with the fixed-order group-by of ``ops/groupby.py``
(integer atomics and a per-target sort, no sort of the whole list).  Each
wrapper launches its kernel for CUDA tensors, counts the launch in its
``launches`` attribute, and runs its plain version for CPU tensors.  No ``index_add_``, ``scatter_add_`` or
``scatter_reduce_`` runs here.
"""

import torch

from . import _build, groupby
from .pairwise import _check_launch, count_launch

CHUNK_ROWS = 1024  # the JAX package's chunk of rows
MAX_K = 1024  # widest list the sparse kernel takes


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_lists(sims, neigh, seg):
    for t, dtype, what in ((sims, torch.float32, "sims"),
                           (neigh, torch.int64, "neigh"),
                           (seg, torch.int32, "seg")):
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or not t.is_contiguous() or t.device != sims.device):
            raise ValueError(f"sparse_medoid_scores: {what} must be a "
                             f"contiguous {dtype} tensor on {sims.device}")
    n_pad, k = sims.shape
    if neigh.shape != (n_pad, k) or seg.shape != (n_pad,):
        raise ValueError("sparse_medoid_scores: sims and neigh (n_pad, k), "
                         "seg (n_pad,)")
    if n_pad > CHUNK_ROWS and n_pad % CHUNK_ROWS:
        raise ValueError(f"sparse_medoid_scores: n_pad {n_pad} is not a "
                         f"multiple of {CHUNK_ROWS}")
    if sims.device.type == "cuda" and k > MAX_K:
        raise ValueError(f"sparse_medoid_scores: the kernel takes lists of "
                         f"at most {MAX_K} slots, got {k}")
    if sims.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sparse_medoid_scores: unsupported device "
                         f"{sims.device}")


def sparse_medoid_scores(sims: torch.Tensor, neigh: torch.Tensor,
                         seg: torch.Tensor, spill: int) -> torch.Tensor:
    """(n_pad,) float32 medoid scores from the exact lists.

    ``sims`` (n_pad, k) float32 and ``neigh`` (n_pad, k) int64 (-1 =
    none) are the engine's padded lists; ``seg`` (n_pad,) int32 is each
    row's cluster, with noise and padded rows in segment ``spill``."""
    _check_lists(sims, neigh, seg)
    if sims.device.type == "cpu":
        return sparse_medoid_scores_plain(sims, neigh, seg, spill)
    n_pad, k = sims.shape
    if n_pad * k >= 2**31:
        raise ValueError("sparse_medoid_scores: the kernel takes n_pad * k "
                         f"< 2**31 list slots, got {n_pad} x {k}")
    dev = sims.device
    lib = _build.library()
    w = torch.empty((n_pad, k), dtype=torch.float32, device=dev)
    tgt = torch.empty((n_pad, k), dtype=torch.int32, device=dev)
    rowsum, out = torch.empty((2, n_pad), dtype=torch.float32, device=dev)
    cnt1 = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev)
    stream = _stream(dev)
    with torch.cuda.device(dev):
        _check_launch("sparse_medoid_scores", lib.falcon_medoid_weights(
            sims.data_ptr(), neigh.data_ptr(), seg.data_ptr(), n_pad, k,
            int(spill), w.data_ptr(), tgt.data_ptr(), rowsum.data_ptr(),
            cnt1.data_ptr(), stream))
        # Each target's flat indices, ordered by the sums kernel into
        # (row, slot) order; the sink n_pad is dropped.
        off, items = groupby.count_and_fill(tgt.view(-1), n_pad, cnt1=cnt1,
                                            stream=stream)
        _check_launch("sparse_medoid_scores", lib.falcon_medoid_sums(
            w.data_ptr(), items.data_ptr(), off.data_ptr(),
            rowsum.data_ptr(), n_pad, k, min(CHUNK_ROWS, n_pad),
            out.data_ptr(), stream))
    count_launch(sparse_medoid_scores)
    return out


sparse_medoid_scores.launches = 0


def xla_row_sums(w: torch.Tensor) -> torch.Tensor:
    """Row sums of a float32 (n, k) tensor in XLA's CPU order: above 32
    entries the row is cut into windows of 32 (the padding split evenly
    before and after), each summed in order, then the windows' sums the
    same way."""
    n, k = w.shape
    if k <= 32:
        acc = torch.zeros(n, dtype=torch.float32, device=w.device)
        for j in range(k):
            acc = acc + w[:, j]
        return acc
    nw = -(-k // 32)
    low = (nw * 32 - k) // 2
    padded = torch.nn.functional.pad(w, (low, nw * 32 - k - low))
    return xla_row_sums(
        xla_row_sums(padded.reshape(n * nw, 32)).reshape(n, nw))


def sparse_medoid_scores_plain(sims: torch.Tensor, neigh: torch.Tensor,
                               seg: torch.Tensor,
                               spill: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sparse_medoid_scores` (any
    device), in the kernel's (and XLA's) order."""
    n_pad, k = sims.shape
    dev = sims.device
    seg = seg.long()
    neigh_safe = neigh.clamp(0, n_pad - 1)
    valid = (neigh >= 0) & (seg[:, None] != spill) & (seg[neigh_safe]
                                                       == seg[:, None])
    rows = torch.arange(n_pad, device=dev)
    mutual = torch.zeros_like(valid)
    for r0 in range(0, n_pad, CHUNK_ROWS):
        r1 = min(r0 + CHUNK_ROWS, n_pad)
        mutual[r0:r1] = (neigh[neigh_safe[r0:r1]]
                         == rows[r0:r1, None, None]).any(-1)
    counted = valid & ((rows[:, None] < neigh_safe) | ~mutual)
    w = torch.where(counted, sims.clamp_min(0.0), 0.0)
    rowsum = xla_row_sums(w)
    # Each target's contributions in (row, slot) order.
    flat_tgt = torch.where(counted, neigh_safe, n_pad).reshape(-1)
    sorted_tgt, perm = torch.sort(flat_tgt, stable=True)
    keep = sorted_tgt < n_pad
    sorted_tgt, perm = sorted_tgt[keep], perm[keep]
    off = torch.searchsorted(sorted_tgt, torch.arange(n_pad + 1, device=dev))
    rank = torch.arange(len(perm), device=dev) - off[sorted_tgt]
    width = int(rank.max()) + 1 if len(perm) else 0
    table = torch.zeros((n_pad, width), dtype=torch.float32, device=dev)
    table[sorted_tgt, rank] = w.reshape(-1)[perm]
    # Contributions from chunks before the target's own come before its
    # row sum: count them per target.
    chunk = min(CHUNK_ROWS, n_pad)
    early = (perm // k) < (sorted_tgt // chunk) * chunk
    prefix = torch.zeros(len(perm) + 1, dtype=torch.int64, device=dev)
    prefix[1:] = torch.cumsum(early.long(), 0)
    before = prefix[off[1:]] - prefix[off[:-1]]
    acc = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    for p in range(width + 1):
        acc = torch.where(before == p, acc + rowsum, acc)
        if p < width:
            acc = acc + table[:, p]  # zero past a target's range: exact
    return acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the sum is rounded to odd in float64
    (nudged one ulp toward its exact error when that is not zero and the
    last bit is even), which rounds to float32 correctly."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def _check_vectors(vectors, seg):
    if (vectors.dtype != torch.float32 or vectors.ndim != 2
            or not vectors.is_contiguous() or seg.dtype != torch.int32
            or seg.ndim != 1 or seg.device != vectors.device
            or seg.shape[0] > vectors.shape[0]):
        raise ValueError("hashed_medoid_scores: vectors must be a contiguous "
                         "float32 (rows, dim) tensor and seg an int32 (n,) "
                         "tensor, n <= rows, on one device")
    if vectors.shape[1] < 8 or (vectors.device.type == "cuda" and (
            vectors.shape[1] % 4 or vectors.data_ptr() % 16)):
        raise ValueError("hashed_medoid_scores: the kernel takes 16-byte "
                         "aligned rows of a multiple of 4 (>= 8) dimensions")


def _segments(seg: torch.Tensor, spill: int):
    """(row ids sorted stably by segment, (spill + 1,) offsets of segments
    0 .. spill - 1 and of the spill segment's start)."""
    sorted_seg, rows = torch.sort(seg, stable=True)
    off = torch.searchsorted(
        sorted_seg, torch.arange(spill + 1, device=seg.device,
                                 dtype=torch.int32))
    return rows, off


def hashed_medoid_scores(vectors: torch.Tensor, seg: torch.Tensor,
                         spill: int) -> torch.Tensor:
    """(n,) float32 scores ``v_i . s_C`` for the first ``n = len(seg)``
    rows of ``vectors`` (rows, dim); ``seg`` (n,) int32 is each row's
    cluster in [0, spill], noise in ``spill``, whose rows score 0."""
    _check_vectors(vectors, seg)
    if vectors.device.type == "cpu":
        return hashed_medoid_scores_plain(vectors, seg, spill)
    dev = vectors.device
    rows, off = _segments(seg, spill)
    out = torch.zeros(seg.shape[0], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _check_launch("hashed_medoid_scores",
                      _build.library().falcon_hashed_medoid_scores(
                          vectors.data_ptr(), vectors.shape[1],
                          rows.data_ptr(), off.data_ptr(), int(spill),
                          out.data_ptr(), _stream(dev)))
    count_launch(hashed_medoid_scores)
    return out


hashed_medoid_scores.launches = 0


def hashed_medoid_scores_plain(vectors: torch.Tensor, seg: torch.Tensor,
                               spill: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`hashed_medoid_scores` (any
    device): segment sums over the member rows in order, then the dot in
    XLA's CPU order: the first 8 products rounded and added in order (XLA's
    first GEMV tile), then one fused multiply-add per dimension."""
    n = seg.shape[0]
    dev = vectors.device
    dim = vectors.shape[1]
    rows, off = _segments(seg, spill)
    sizes = off[1:] - off[:-1]
    sums = torch.zeros((spill + 1, dim), dtype=torch.float32, device=dev)
    segs = torch.arange(spill, device=dev)
    for p in range(int(sizes.max()) if spill else 0):
        has = sizes > p
        sums[segs[has]] = sums[segs[has]] + vectors[rows[off[:-1][has] + p]]
    v = vectors[:n]
    s = sums[seg.long()]
    acc = v[:, 0] * s[:, 0]
    for d in range(1, 8):
        acc = acc + v[:, d] * s[:, d]
    for d in range(8, dim):
        acc = _fma(v[:, d], s[:, d], acc)
    return torch.where(seg == spill, 0.0, acc)
