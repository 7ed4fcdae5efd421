"""Banded k-nearest-neighbour search over hashed spectrum vectors.

Port of ``falcon_tpu/ops/knn.py``: the ``NEG`` sentinel, the power-of-two
bucketing rule, ``band_bounds`` (a NumPy copy: the JAX module imports JAX
when it is imported), ``stable_topk`` / ``merge_topk``, and ``knn_banded``
with its RT and validity mask ``mask_invalid``.

Spectra are sorted by precursor m/z, so each row's candidates are a
contiguous band of columns.  ``knn_banded`` scores row blocks against one
column window each (the JAX package's geometry: ``block_rows`` rows, a
power-of-two window covering the union of their bands, the row block
halved while its float32 score tile exceeds 128 MiB), masks the pairs
outside the precursor tolerance and the self-pairs, and keeps each row's
exact top k.  The product is a plain matrix product, as the JAX package
leaves it to XLA.  With ``scan_bf16`` its operands are rounded to
bfloat16 and multiplied in float32, which gives the f32-exact products
and f32 sums of XLA's bf16 dot with a float32 result; TF32 is refused,
since it would round again and break the certified margin of the
prefilter (``falcon_tpu/ops/knn.py::_banded_topk``).  Not ported:
``approx_max_k`` retrieval with its certified counts, and the boundary
continuation; the ann engine's one wide pass takes their place
(``cluster/ann_engine.py``).

Top-k order is the JAX package's: score descending, ties to the lower
position.  ``torch.topk`` promises no order for ties on CUDA, so every
top-k of the port is a stable descending sort (``stable_topk``).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .matching import f32_tolerance

NEG = -2.0  # below any cosine similarity
# Largest float32 score tile (block_rows x window) of one scan step, the
# JAX package's rule: the row block halves until its tile fits.
TILE_BYTES = 128 * 2**20


def _pow2_at_least(x: int, minimum: int = 512) -> int:
    size = minimum
    while size < x:
        size *= 2
    return size


def band_bounds(mzs: np.ndarray, tol_mass: float, tol_is_da: bool):
    """Per-row tolerance-band bounds (inclusive lo, exclusive hi) of
    SORTED precursor m/z, covering the device's float32 acceptance test.

    The bounds come from the float32 m/z the device compares, widened by
    a few float32 ULPs, so a window never excludes a boundary pair that
    the float32 test accepts (``falcon_tpu/ops/knn.py::band_bounds``).
    """
    mzs32 = np.asarray(mzs, np.float64).astype(np.float32).astype(
        np.float64)
    ulp = 4e-7  # ~3.4 float32 ULPs of relative slack
    if tol_is_da:
        slack = ulp * np.abs(mzs32)
        lo_vals = mzs32 - tol_mass - slack
        hi_vals = mzs32 + tol_mass + slack
    else:
        # The test accepts |q-c|/c*1e6 <= tol, i.e. candidates up to
        # q/(1-tol/1e6) (> q*(1+tol/1e6) by ~q*tol^2).
        lo_vals = mzs32 / (1 + tol_mass / 1e6) * (1 - ulp)
        hi_vals = mzs32 / (1 - tol_mass / 1e6) * (1 + ulp)
    return (np.searchsorted(mzs32, lo_vals, side="left"),
            np.searchsorted(mzs32, hi_vals, side="right"))


def stable_topk(values: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their positions, as
    ``lax.top_k`` orders them: descending, ties to the lower position."""
    top, pos = torch.sort(values, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]


def merge_topk(s1: torch.Tensor, i1: torch.Tensor, s2: torch.Tensor,
               i2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (rows, k') top-k result pairs into the best ``k``; on a
    tie the first pair's entry wins."""
    top, pos = stable_topk(torch.cat([s1, s2], dim=1), k)
    return top, torch.gather(torch.cat([i1, i2], dim=1), 1, pos)


def block_geometry(band_lo: np.ndarray, band_hi: np.ndarray, n: int,
                   block_rows: int) -> Tuple[np.ndarray, int, int, int]:
    """(column window start per row block, block rows, window, n_pad) of
    the scan, the JAX package's rule: the window is the power-of-two
    envelope of the widest union of a block's bands (at least one block),
    capped at ``n_pad``; the block halves while its float32 score tile
    exceeds ``TILE_BYTES``; every start is clamped so its window ends
    inside ``n_pad``."""
    n_pad = _pow2_at_least(n)
    block_rows = min(block_rows, n_pad)
    while True:
        starts = np.zeros(n_pad // block_rows, np.int64)
        max_span = block_rows
        for b in range(-(-n // block_rows)):
            r0, r1 = b * block_rows, min((b + 1) * block_rows, n)
            lo = int(band_lo[r0])
            max_span = max(max_span, max(int(band_hi[r1 - 1]), r1) - lo)
            starts[b] = lo
        window = min(_pow2_at_least(max_span, block_rows), n_pad)
        if block_rows <= 512 or block_rows * window * 4 <= TILE_BYTES:
            break
        block_rows //= 2
    starts = np.minimum(starts, max(n_pad - window, 0))
    return starts, block_rows, window, n_pad


def mask_invalid(scores: torch.Tensor, idx: torch.Tensor, n: int,
                 rts: Optional[torch.Tensor],
                 rt_tol: Optional[float]) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``falcon_tpu/ops/knn.py::_mask_invalid``: ids outside [0, n) and,
    with ``rts`` (float32 per padded row, +inf on padding), neighbours
    more than ``rt_tol`` (compared in float32) away in retention time
    become ``NEG`` / -1, in place in the sorted lists."""
    bad = (idx < 0) | (idx >= n)
    if rts is not None:
        neigh_rt = rts[idx.clamp(0, rts.shape[0] - 1)]
        bad |= ((neigh_rt - rts[:scores.shape[0], None]).abs()
                > f32_tolerance(rt_tol))
    return torch.where(bad, NEG, scores), torch.where(bad, -1, idx)


def _tf32_matmuls() -> bool:
    """Whether CUDA float32 matmuls may run in TF32.  Reads the precision
    API (``torch.backends.cuda.matmul.fp32_precision``, "none" deferring
    to ``torch.backends.fp32_precision``) where it exists: reading the
    legacy ``allow_tf32`` after TF32 was set through it raises.  The
    legacy flag is read only where the new attribute is missing."""
    matmul = torch.backends.cuda.matmul
    precision = getattr(matmul, "fp32_precision", None)
    if precision is None:
        return bool(matmul.allow_tf32)
    if precision == "none":
        precision = getattr(torch.backends, "fp32_precision", "none")
    return precision == "tf32"


def refuse_tf32(name: str, device: torch.device) -> None:
    """Raise if float32 products on ``device`` would run in TF32, which
    rounds the operands to 10 mantissa bits: the upper bounds (and the
    bf16 scan's certified margin) need full float32 products, and the
    ``--rerank off`` scan thresholds eps on its float32 scores."""
    if device.type == "cuda" and _tf32_matmuls():
        raise RuntimeError(
            f"{name} needs full float32 matmuls; TF32 is on "
            "(torch.backends.cuda.matmul.fp32_precision / allow_tf32 / "
            "torch.set_float32_matmul_precision)")


def knn_banded(
    vectors: torch.Tensor,
    precursor_mzs: np.ndarray,
    tol_mass: float,
    tol_mode: str,
    k: int,
    block_rows: int = 1024,
    rts: Optional[np.ndarray] = None,
    rt_tol: Optional[float] = None,
    q_vectors: Optional[torch.Tensor] = None,
    scan_bf16: bool = False,
    sub_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``k`` neighbours within the precursor tolerance band.

    ``vectors`` (>= n, D) float32 column vectors on the device, rows in
    ``precursor_mzs`` order (SORTED ascending, (n,)); ``q_vectors`` the
    same shape, an asymmetric query matrix (the prefilter's spread
    vectors), else the columns themselves.  Row i is scored against the
    in-band columns j != i as ``q_i . v_j``.  Returns (scores float32,
    ids int64) on the device, each (n_pad, min(k, window)), ``n_pad`` =
    ``_pow2_at_least(n)``; missing neighbours, padded rows and, with
    ``rts`` and ``rt_tol``, neighbours outside the RT tolerance are
    ``NEG`` / -1 (the JAX package's ``as_device=True, exact_topk=True``).

    ``sub_window``: cover each block's window in column passes of this
    many columns (floored at k, rounded up to a power of two, as the JAX
    package's ``FALCON_TPU_KNN_COL_CHUNK``); by default one pass unless
    the (block_rows, window) tile exceeds ``TILE_BYTES``.  Passes merge
    exactly, so the result does not depend on it.
    """
    device = vectors.device
    for v in (vectors,) if q_vectors is None else (vectors, q_vectors):
        if (v.dtype != torch.float32 or v.ndim != 2 or v.device != device
                or v.shape != vectors.shape):
            raise ValueError("knn_banded: vectors and q_vectors must be "
                             "float32 (rows, D) tensors of one shape on one "
                             "device")
    refuse_tf32("knn_banded", device)
    n = len(precursor_mzs)
    mzs = np.asarray(precursor_mzs, np.float64)
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_mode == "Da")
    starts, block_rows, window, n_pad = block_geometry(band_lo, band_hi, n,
                                                       block_rows)
    k = min(int(k), window)
    floor = max(block_rows, _pow2_at_least(k, 512))
    if sub_window is None:
        sub_window = window
        while (block_rows * sub_window * 4 > TILE_BYTES
               and sub_window // 2 >= floor):
            sub_window //= 2
    else:
        sub_window = min(window, _pow2_at_least(max(int(sub_window), k), 128))

    def rows_of(v):
        v = v[:n_pad]
        if v.shape[0] < n_pad:
            v = torch.nn.functional.pad(v, (0, 0, 0, n_pad - v.shape[0]))
        # bf16 operands multiplied exactly in float32, summed in float32.
        return v.bfloat16().float() if scan_bf16 else v

    cols = rows_of(vectors)
    queries = cols if q_vectors is None else rows_of(q_vectors)
    mz_host = np.full(n_pad, np.inf, np.float32)
    mz_host[:n] = mzs
    mz_dev = torch.from_numpy(mz_host).to(device)
    tol32 = f32_tolerance(tol_mass)
    lane = torch.arange(sub_window, device=device)
    block_lane = torch.arange(block_rows, device=device)

    parts_s, parts_i = [], []
    for b in range(-(-n // block_rows)):
        r0 = b * block_rows
        q = queries[r0:r0 + block_rows]
        q_mz = mz_dev[r0:r0 + block_rows, None]
        q_rows = (r0 + block_lane)[:, None]
        acc_s = acc_i = None
        for c0 in range(int(starts[b]), int(starts[b]) + window, sub_window):
            sims = q @ cols[c0:c0 + sub_window].t()
            c_mz = mz_dev[c0:c0 + sub_window][None, :]
            diff = q_mz - c_mz
            mass = diff.abs() if tol_mode == "Da" else (diff / c_mz
                                                        * 1e6).abs()
            valid = ((mass <= tol32) & torch.isfinite(c_mz)
                     & (q_rows != c0 + lane[None, :]))
            top, pos = stable_topk(torch.where(valid, sims, NEG), k)
            ids = torch.where(top > NEG, c0 + pos, -1)
            if acc_s is None:
                acc_s, acc_i = top, ids
            else:
                acc_s, acc_i = merge_topk(acc_s, acc_i, top, ids, k)
        parts_s.append(acc_s)
        parts_i.append(acc_i)
    # Rows from n on are padding: every pair of theirs is masked.
    n_done = -(-n // block_rows) * block_rows
    parts_s.append(torch.full((n_pad - n_done, k), NEG, device=device))
    parts_i.append(torch.full((n_pad - n_done, k), -1, dtype=torch.int64,
                              device=device))
    scores, ids = torch.cat(parts_s), torch.cat(parts_i)
    rt_dev = None
    if rts is not None and rt_tol is not None:
        rt_host = np.full(n_pad, np.inf, np.float32)
        rt_host[:n] = rts
        rt_dev = torch.from_numpy(rt_host).to(device)
    return mask_invalid(scores, ids, n, rt_dev, rt_tol)
