"""Consensus spectra: a CUDA kernel for the per-key sums and the host code
around it.

Port of ``falcon_tpu/ops/consensus.py``: all member peaks of a cluster are
discretised to ``fragment_tol`` bins, bins supported by at least
``min_fraction`` of the cluster's members survive, and each surviving bin
becomes one consensus peak at the intensity-weighted mean m/z with the
member-averaged intensity (L2-renormalised, capped at ``max_peaks``).

``aggregate`` is the device part (the JAX package's ``_get_aggregate``):
the peaks in stable order of (cluster-bin key, member), then per key the
intensity sum, the intensity-weighted m/z sum, the number of distinct
members and the key.  XLA adds those up one peak after another in sorted
order.  The plain version sorts (``torch.sort``) and ``segment_sums_plain``
walks the runs; the kernels (``csrc/consensus.cu``) reach the same order
with the fixed-order group-by of ``ops/groupby.py`` (buckets of high key
bits, each ordered on its own), so they agree bit for bit with each other
and with the JAX package on the CPU, and the m/z printed into the MGF does
not change from run to run.  ``consensus_spectra`` keeps the JAX
package's chunked int32 composite keys and its host code, verbatim.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build, groupby
from .pairwise import _check_launch, count_launch


def _sorted_runs(bin_key, member, mz, intensity):
    """The peaks sorted stably by (key, member), and (n_keys + 1,) int64
    offsets of each key's run."""
    order = torch.sort((bin_key.long() << 32) | member.long(),
                       stable=True)[1]
    bin_key, member, mz, intensity = (a[order] for a in (bin_key, member, mz,
                                                         intensity))
    first = torch.ones(bin_key.shape[0], dtype=torch.bool,
                       device=bin_key.device)
    first[1:] = bin_key[1:] != bin_key[:-1]
    off = torch.cat([torch.nonzero(first)[:, 0],
                     torch.tensor([bin_key.shape[0]], device=bin_key.device)])
    return (bin_key, member, mz, intensity), off


WARP_CAP = 256  # csrc/consensus.cu CONS_WARP_CAP: a warp orders a bucket


def bucket_shift(max_key: int, n: int) -> Tuple[int, int]:
    """(shift, buckets): the kernels group keys below ``max_key`` by
    ``key >> shift``, the smallest shift that makes the buckets at most as
    many as the ``n`` peaks."""
    shift = 0
    while ((max_key - 1) >> shift) + 1 > n:
        shift += 1
    return shift, ((max_key - 1) >> shift) + 1


def aggregate(bin_key: torch.Tensor, member: torch.Tensor, mz: torch.Tensor,
              intensity: torch.Tensor,
              max_key: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Per distinct key, in key order: (key int32, intensity sum float32,
    intensity-weighted m/z sum float32, distinct members int32), each
    (n_keys,) on the inputs' device.  Inputs are (n,) int32 non-negative
    keys and members and float32 m/z and intensity, n >= 1, in any order.
    ``max_key``: a bound above every key, if the caller knows one (else
    the kernel's wrapper reads the largest key back)."""
    for t, dtype in ((bin_key, torch.int32), (member, torch.int32),
                     (mz, torch.float32), (intensity, torch.float32)):
        if (t.dtype != dtype or t.ndim != 1 or t.shape != bin_key.shape
                or t.device != bin_key.device or not t.is_contiguous()):
            raise ValueError("aggregate: keys and members int32, m/z and "
                             "intensity float32, all (n,) on one device")
    n = bin_key.shape[0]
    if n == 0:
        raise ValueError("aggregate: no peaks")
    if bin_key.device.type == "cpu":
        return aggregate_plain(bin_key, member, mz, intensity)
    if max_key is None:
        max_key = int(bin_key.max()) + 1
    if not 0 < max_key <= 2**31:
        raise ValueError(f"aggregate: max_key {max_key} not in [1, 2**31]")
    shift, n_buckets = bucket_shift(max_key, n)
    dev = bin_key.device
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # Rows: key, intensity sum, m/z sum, members; the sums as float32.
    tmp, out = (torch.empty((4, n), dtype=torch.int32, device=dev)
                for _ in range(2))
    kcnt1 = torch.empty(n_buckets + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        off, items = groupby.count_and_fill(bin_key, n_buckets, shift,
                                            stream=stream)
        _check_launch("aggregate", lib.falcon_consensus_walk(
            bin_key.data_ptr(), member.data_ptr(), mz.data_ptr(),
            intensity.data_ptr(), items.data_ptr(), off.data_ptr(),
            n_buckets, *(r.data_ptr() for r in tmp), kcnt1.data_ptr(),
            stream))
        koff = torch.cumsum(kcnt1, 0, dtype=torch.int32)
        _check_launch("aggregate", lib.falcon_consensus_compact(
            off.data_ptr(), koff.data_ptr(), n_buckets,
            *(r.data_ptr() for r in tmp), *(r.data_ptr() for r in out),
            stream))
    count_launch(aggregate)
    n_keys = int(koff[-1])  # the one wait on the card
    keys, int_sum, mzint_sum, members = out[:, :n_keys]
    return (keys, int_sum.view(torch.float32), mzint_sum.view(torch.float32),
            members)


aggregate.launches = 0


def aggregate_plain(bin_key: torch.Tensor, member: torch.Tensor,
                    mz: torch.Tensor, intensity: torch.Tensor,
                    max_key: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`aggregate` (any device); it needs
    no ``max_key``."""
    (key_s, member_s, mz_s, int_s), off = _sorted_runs(bin_key, member, mz,
                                                       intensity)
    return segment_sums_plain(key_s, member_s, mz_s, int_s, off)


def segment_sums_plain(key_s, member_s, mz_s, int_s, off):
    """The kernel's per-key walk over sorted peaks, vectorised over keys:
    step p adds each key's p-th peak, so every sum runs in sorted order
    (a key past its run adds nothing)."""
    n = key_s.shape[0]
    starts, sizes = off[:-1], off[1:] - off[:-1]
    new_member = torch.ones(n, dtype=torch.bool, device=key_s.device)
    new_member[1:] = (key_s[1:] != key_s[:-1]) | (member_s[1:]
                                                  != member_s[:-1])
    products = mz_s * int_s
    int_sum = torch.zeros(starts.shape[0], dtype=torch.float32,
                          device=key_s.device)
    mzint_sum = torch.zeros_like(int_sum)
    for p in range(int(sizes.max())):
        idx = (starts + p).clamp_max(n - 1)
        live = sizes > p
        int_sum = torch.where(live, int_sum + int_s[idx], int_sum)
        mzint_sum = torch.where(live, mzint_sum + products[idx], mzint_sum)
    counts = torch.cumsum(new_member.int(), 0)
    members = (counts[off[1:] - 1] - counts[starts]
               + new_member[starts].int()).int()
    return key_s[starts], int_sum, mzint_sum, members


def consensus_spectra(
    offsets: np.ndarray,
    mz_flat: np.ndarray,
    intensity_flat: np.ndarray,
    labels: np.ndarray,
    fragment_tol: float,
    min_mz: float,
    min_fraction: float = 0.5,
    max_peaks: Optional[int] = 50,
    cluster_filter: Optional[np.ndarray] = None,
    device=None,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Consensus peaks per cluster label.

    ``offsets``/``mz_flat``/``intensity_flat``: the ragged peak arrays of
    one charge dataset (store layout).  ``labels``: per-row cluster label
    (dataset row order); labels must be NON-NEGATIVE — the engines
    promote noise (-1) to singleton labels before this runs.  Returns {label: (mz, intensity)} with intensity
    L2-normalized, for the labels in ``cluster_filter`` (default: all).
    ``device``: where :func:`aggregate` runs (see
    ``falcon_tpu_torch.device.resolve_device``).

    Single-member clusters pass their (already preprocessed) spectrum
    through unchanged.
    """
    from ..device import resolve_device

    dev = resolve_device(device)
    labels = np.asarray(labels)
    n_rows = len(labels)
    lengths = np.diff(offsets).astype(np.int64)
    if cluster_filter is not None:
        keep_label = np.zeros(int(labels.max()) + 1, bool)
        keep_label[np.asarray(cluster_filter, np.int64)] = True
        row_mask = keep_label[labels]
    else:
        row_mask = np.ones(n_rows, bool)

    sizes = np.bincount(labels[row_mask],
                        minlength=int(labels.max()) + 1)

    flat_mask = np.repeat(row_mask, lengths)
    mz = np.asarray(mz_flat, np.float32)[flat_mask]
    intensity = np.asarray(intensity_flat, np.float32)[flat_mask]
    peak_labels = np.repeat(labels[row_mask].astype(np.int64),
                            lengths[row_mask])
    peak_member = np.repeat(
        np.arange(n_rows, dtype=np.int32)[row_mask], lengths[row_mask]
    )
    n_peaks = len(mz)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if n_peaks == 0:
        return out

    bins = np.floor((mz.astype(np.float64) - min_mz) / fragment_tol)
    bins = np.maximum(bins, 0).astype(np.int64)
    n_bins = int(bins.max()) + 1

    # The JAX package's 32-bit composite keys: the (cluster, bin) key is
    # built per label-range chunk such that chunk_size * n_bins stays
    # below int32 max.
    big = np.int32(2**31 - 1)
    labels_per_chunk = max((2**31 - 2) // n_bins, 1)
    max_label = int(peak_labels.max())
    parts = []
    for base in range(0, max_label + 1, labels_per_chunk):
        chunk_mask = ((peak_labels >= base)
                      & (peak_labels < base + labels_per_chunk))
        if not chunk_mask.any():
            continue
        key32 = ((peak_labels[chunk_mask] - base) * n_bins
                 + bins[chunk_mask]).astype(np.int32)
        keys, int_sum, mzint_sum, members = (
            t.cpu().numpy() for t in aggregate(*(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (key32, peak_member[chunk_mask], mz[chunk_mask],
                          intensity[chunk_mask])),
                max_key=int(key32.max()) + 1))
        real = keys < big
        parts.append((
            base + (keys[real] // n_bins).astype(np.int64),
            keys[real] % n_bins,
            int_sum[real],
            mzint_sum[real],
            members[real],
        ))
    bin_cluster = np.concatenate([p[0] for p in parts])
    int_sum = np.concatenate([p[2] for p in parts])
    mzint_sum = np.concatenate([p[3] for p in parts])
    members = np.concatenate([p[4] for p in parts])
    mz_mean = mzint_sum / np.maximum(int_sum, 1e-12)
    int_mean = int_sum / np.maximum(members, 1)

    # Per cluster: keep bins supported by >= min_fraction of members,
    # cap at max_peaks most intense, sort by m/z, L2-normalize.
    order = np.argsort(bin_cluster, kind="stable")
    bounds = np.flatnonzero(
        np.diff(bin_cluster[order], prepend=-1, append=-1)
    )
    for s, e in zip(bounds[:-1], bounds[1:]):
        idx = order[s:e]
        label = int(bin_cluster[idx[0]])
        size = int(sizes[label])
        need = max(int(np.ceil(min_fraction * size)), 1)
        keep = members[idx] >= need
        if not keep.any():
            # Degenerate (no bin reaches quorum): fall back to the single
            # best-supported bin so every cluster exports something.
            keep = members[idx] == members[idx].max()
        sel = idx[keep]
        if max_peaks is not None and len(sel) > max_peaks:
            top = np.argsort(int_mean[sel], kind="stable")[-max_peaks:]
            sel = sel[top]
        mz_sel = mz_mean[sel]
        int_sel = int_mean[sel]
        mz_order = np.argsort(mz_sel, kind="stable")
        mz_sel, int_sel = mz_sel[mz_order], int_sel[mz_order]
        norm = np.linalg.norm(int_sel)
        out[label] = (
            mz_sel.astype(np.float32),
            (int_sel / max(norm, 1e-12)).astype(np.float32),
        )
    return out
