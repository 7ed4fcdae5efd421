"""A device mesh and its collectives, driven from one process.

Port of ``falcon_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_rows``) and
of the named collectives that the JAX package's sharded modules call inside
``shard_map``.  A :class:`Mesh` is an ordered tuple of ``torch.device``\\ s
(the cards of ``device.visible_devices``, or N virtual shards of one card
or of the CPU) and an axis name.  A sharded array is a list of per-shard
tensors, shard ``i`` on ``mesh.devices[i]``, and each collective is a plain
function over such lists:

- ``ppermute``: shard ``src`` copied to device ``dst`` (``.to(dst,
  non_blocking=True)``, a peer copy between cards; on a virtual mesh the
  same tensor, so a received shard is never written in place);
- ``all_gather``: the shards concatenated in mesh order on every device
  (``tiled=True``);
- ``pmin``: the elementwise minimum of the shards on every device;
- ``psum``: the shards added in mesh order 0 .. N-1 on every device, the
  order of XLA's CPU all-reduce (measured: a left fold over the devices), so
  the sum is the JAX package's bit for bit and a second run gives the same
  bytes.  Each device folds in that order, so every replica holds the same
  bits.

One process, not ``torch.distributed``: the JAX package is single-controller
(``python -m falcon_tpu --devices 4`` is one process, and the port's CLI is
the same command with the same output), NCCL refuses two ranks on one GPU,
and one process can hold N virtual shards of one card, which is how the
sharded path is held against the one-device path on the CPU tests and on
one H100.  A replicated result is computed once per distinct device and
shared by that device's shards.

``multichip_cluster_step`` is the JAX package's one-step clustering of
rows sharded over a mesh (its ``_local_step`` under ``shard_map``), on the
port's kernels: the hashed vectors (``csrc/vectorize.cu``), the k-means
update's per-shard list sums (B.2's sums kernel) added by ``psum``, the
hashed k-NN against all-gathered vectors, and an exact tile through K1.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, visible_devices
from ..ops import medoids
from ..ops.knn import refuse_tf32, stable_topk
from ..ops.matching import f32_tolerance
from ..ops.pairwise import panel_scores
from ..ops.vectorize import normalize_rows, vectorize


@dataclass(frozen=True)
class Mesh:
    """An ordered set of devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "spectra"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis: str = "spectra") -> Mesh:
    """The first ``n_devices`` of ``visible_devices`` of the run's device
    (``device``: see ``resolve_device``), all of them by default."""
    devices = visible_devices(resolve_device(device))
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices requested, "
                             f"{len(devices)} visible")
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis)


def shard_rows(mesh: Mesh, array: torch.Tensor) -> List[torch.Tensor]:
    """``array``'s leading axis cut into ``mesh.size`` equal contiguous
    shards, shard ``i`` on ``mesh.devices[i]``."""
    n = array.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_rows: {n} rows do not split into "
                         f"{mesh.size} equal shards")
    local = n // mesh.size
    return [array[i * local:(i + 1) * local].to(d, non_blocking=True)
            for i, d in enumerate(mesh.devices)]


def ppermute(mesh: Mesh, shards: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``out[dst] = shards[src]`` on ``mesh.devices[dst]`` for each
    ``(src, dst)`` of ``perm``, a permutation of the mesh."""
    if sorted(dst for _, dst in perm) != list(range(mesh.size)):
        raise ValueError("ppermute: perm must give every device one shard")
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for src, dst in perm:
        out[dst] = shards[src].to(mesh.devices[dst], non_blocking=True)
    return out


def _replicated(mesh: Mesh, fn: Callable[[torch.device], torch.Tensor]
                ) -> List[torch.Tensor]:
    """``fn(device)`` for each shard, computed once per distinct
    device."""
    done: Dict[torch.device, torch.Tensor] = {}
    for d in mesh.devices:
        if d not in done:
            done[d] = fn(d)
    return [done[d] for d in mesh.devices]


def all_gather(mesh: Mesh,
               shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards concatenated along the leading axis, in mesh order, on
    every device."""
    return _replicated(mesh, lambda d: torch.cat(
        [s.to(d, non_blocking=True) for s in shards]))


def _fold(mesh: Mesh, shards: Sequence[torch.Tensor], op
          ) -> List[torch.Tensor]:
    def on(d):
        acc = shards[0].to(d, non_blocking=True)
        for s in shards[1:]:
            acc = op(acc, s.to(d, non_blocking=True))
        return acc

    return _replicated(mesh, on)


def pmin(mesh: Mesh, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise minimum of the shards, on every device."""
    return _fold(mesh, shards, torch.minimum)


def psum(mesh: Mesh, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards added in mesh order, ``((s0 + s1) + s2) + ...``, on every
    device."""
    return _fold(mesh, shards, torch.add)


def _local_step(mz_peaks: torch.Tensor, int_peaks: torch.Tensor,
                mapping: torch.Tensor, centroids: torch.Tensor,
                min_bound: float, bin_size: float, n_bins: int):
    """One shard's part of the step before its collectives: (its unit
    vectors, its rows' sums per nearest list, its rows' counts per list)."""
    n_lists, dim = centroids.shape
    vectors = normalize_rows(vectorize(mz_peaks, int_peaks, mapping,
                                       min_bound, bin_size, n_bins, dim,
                                       norm=False))
    refuse_tf32("multichip_cluster_step", vectors.device)
    assign = torch.argmax(vectors @ centroids.t(), dim=1).int()
    return (vectors, medoids.segment_sums(vectors, assign, n_lists),
            torch.bincount(assign.long(), minlength=n_lists).float())


def multichip_cluster_step(
    mesh: Mesh,
    mz_peaks: np.ndarray,
    int_peaks: np.ndarray,
    precursor_mz: np.ndarray,
    mapping: np.ndarray,
    centroids: np.ndarray,
    min_bound: float,
    bin_size: float,
    n_bins: int,
    fragment_tol: float = 0.05,
    precursor_tol_mass: float = 20.0,
    precursor_tol_mode: str = "ppm",
    k: int = 8,
    exact_rows: int = 8,
):
    """One clustering step with rows (spectra) sharded over ``mesh``.

    ``mz_peaks`` / ``int_peaks`` (n, P) padded peaks (L2-normalised
    intensities), ``precursor_mz`` (n,), ``mapping`` the (n_bins,) hashed
    bin -> dimension table and ``centroids`` (n_lists, D) the quantizer,
    both replicated; n must split into ``mesh.size`` equal shards.  Each
    shard: its hashed unit vectors; each row's nearest centroid and the
    shard's list sums and counts, added over the mesh by ``psum`` into the
    updated, renormalised centroids (an empty list keeps its centroid);
    the all-gathered vectors and precursor m/z, each row's top ``k`` cosines
    in its precursor band (not itself, others -2); and the exact scores of
    its first ``exact_rows`` rows against every spectrum (K1).  Returns
    (centroids (n_lists, D), top-k scores (n, k), top-k ids (n, k), exact
    tile (mesh.size * exact_rows, n)), on ``mesh.devices[0]``, as the JAX
    package's ``multichip_cluster_step`` returns its global arrays."""
    home = mesh.devices[0]

    def rows(array):
        return shard_rows(mesh, torch.from_numpy(
            np.ascontiguousarray(array, np.float32)))

    mz_s, int_s, pmz_s = rows(mz_peaks), rows(int_peaks), rows(precursor_mz)
    mapping_r = _replicated(mesh, lambda dev: torch.from_numpy(
        np.asarray(mapping, np.int64)).to(dev))
    cent_r = _replicated(mesh, lambda dev: torch.from_numpy(
        np.ascontiguousarray(centroids, np.float32)).to(dev))
    vectors, sums, counts = zip(*(
        _local_step(mz_s[d], int_s[d], mapping_r[d], cent_r[d], min_bound,
                    bin_size, n_bins)
        for d in range(mesh.size)))
    sums, counts = psum(mesh, sums), psum(mesh, counts)
    new_centroids = normalize_rows(torch.where(counts[0][:, None] > 0,
                                               sums[0], cent_r[0]))
    all_vectors = all_gather(mesh, vectors)
    all_pmz = all_gather(mesh, pmz_s)
    all_mz, all_int = all_gather(mesh, mz_s), all_gather(mesh, int_s)
    tol = f32_tolerance(precursor_tol_mass)
    top_s, top_i, exact = [], [], []
    for d in range(mesh.size):
        n_local = vectors[d].shape[0]
        sims = vectors[d] @ all_vectors[d].t()
        diff = pmz_s[d][:, None] - all_pmz[d][None, :]
        if precursor_tol_mode == "Da":
            mass = diff.abs()
        else:
            mass = (diff / all_pmz[d][None, :] * 1e6).abs()
        row = d * n_local + torch.arange(n_local, device=sims.device)
        not_self = row[:, None] != torch.arange(sims.shape[1],
                                                device=sims.device)
        s, i = stable_topk(torch.where((mass <= tol) & not_self, sims, -2.0),
                           k)
        top_s.append(s.to(home))
        top_i.append(i.to(home))
        tile, _ = panel_scores(
            mz_s[d][:exact_rows].contiguous(),
            int_s[d][:exact_rows].contiguous(), all_mz[d], all_int[d], 0,
            fragment_tol, with_matches=False)
        exact.append(tile.to(home))
    return (new_centroids.to(home), torch.cat(top_s), torch.cat(top_i),
            torch.cat(exact))
