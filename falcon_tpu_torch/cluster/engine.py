"""Per-charge clustering engine (exact backend) on PyTorch and CUDA.

Port of ``falcon_tpu/cluster/engine.py``, with the same observable
behaviour: precursor-m/z intervals, all-pairs peak-matching distances on the
device, native linkage and distance cut, refinement and medoids on the
host, and the same labels and medoids.  The intervals of 2 or more spectra
go to the stage both engines share (``cluster/grouped.py``): those of up
to ``GROUP_MAX`` spectra are scored together by the grouped kernel (K4)
and linked a launch at a time; larger ones stream row panels through the
panel kernel (K1) (``ops/pairwise.py``), or with ``--devices N`` cut
their condensed pairs over a mesh of N devices
(``parallel/sharded_exact.py``), and are linked one at a time.

The interval splits, native linkage and post-processing are the port's
copies of the JAX package's host modules.
"""

import logging
from typing import Optional, Tuple

import numpy as np

from ..device import resolve_device, visible_devices
from ..ops import pairwise
from ..parallel.mesh import Mesh
from ..parallel.sharded_exact import condensed_distances_sharded
from ..store.store import ChargeDataset
from ..utils.profiling import profiler
from .grouped import score_and_link
from .intervals import precursor_mz_splits
from .postprocess import assign_global_cluster_labels

logger = logging.getLogger("falcon_tpu")

GROUP_MAX = 1024  # largest interval scored by the grouped kernel


def generate_clusters(
    dataset: ChargeDataset,
    linkage: str,
    distance_threshold: float,
    min_matches: int,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    fragment_tol: float,
    batch_size: int,
    max_peaks: int = 50,
    rounds: Optional[int] = None,
    devices: Optional[int] = None,
    device=None,
    panel_only: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster one charge bucket; returns (labels, medoid row indices).

    Labels are globally unique within the bucket; every spectrum gets a
    label (noise points become singleton clusters).  ``device``: see
    ``falcon_tpu_torch.device.resolve_device``.  ``panel_only`` sends every
    interval through the panel kernel route, as the JAX engine's
    ``backend="pallas_interpret"`` does, so tests reach that route at
    small sizes.
    """
    dev = resolve_device(device)

    meta = dataset.read_metadata(
        columns=("precursor_mz", "retention_time")
    )
    offsets, mz_flat, int_flat = dataset.read_peaks()
    n = len(meta["precursor_mz"])
    precursor_mzs = np.asarray(meta["precursor_mz"], np.float64)
    rts = np.asarray(meta["retention_time"], np.float64)

    order = np.argsort(precursor_mzs, kind="stable")
    mz_sorted = precursor_mzs[order]
    rt_sorted = rts[order]

    splits = precursor_mz_splits(
        mz_sorted, precursor_tol_mass, precursor_tol_mode, batch_size
    )
    logger.info(
        "Cluster %d spectra using %s linkage and distance threshold %.3f "
        "(%d precursor m/z intervals)",
        n, linkage, distance_threshold, len(splits) - 1,
    )

    pad_to = ((max(max_peaks, 1) + 63) // 64) * 64
    sizes = np.diff(splits)
    group_max = 0 if panel_only else GROUP_MAX

    # --devices N: the condensed pairs of each large interval are cut over
    # a mesh (parallel/sharded_exact.py), each pair scored once, the same
    # condensed output; small groups stay as they are.
    mesh = None
    if devices is not None and devices > 1:
        visible = visible_devices(dev)
        if len(visible) < devices:
            logger.warning(
                "Requested %d devices but only %d visible; exact panel "
                "scoring stays single-device", devices, len(visible),
            )
        elif (sizes > group_max).any():
            mesh = Mesh(tuple(visible[:devices]))
    kwargs = {} if rounds is None else {"rounds": rounds}

    def score_large(mz_pad, int_pad, d):
        if mesh is not None:
            pdist = condensed_distances_sharded(
                mz_pad, int_pad, fragment_tol, min_matches, mesh, **kwargs)
            if pdist is not None:  # None: too large for int32
                return pdist
        return pairwise.condensed_distances(
            mz_pad, int_pad, fragment_tol, min_matches, device=d, **kwargs)

    # The intervals of 2 or more spectra are the stage's groups, in
    # interval order; a lone spectrum stays noise.  The cut reads a
    # distance in float64, so the whole test does too.
    grouped = sizes >= 2
    pos = np.flatnonzero(np.repeat(grouped, sizes))
    group_off = np.zeros(int(grouped.sum()) + 1, np.int64)
    np.cumsum(sizes[grouped], out=group_off[1:])
    linked = score_and_link(
        offsets, mz_flat, int_flat, pad_to, order[pos], group_off,
        mz_sorted[pos], rt_sorted[pos] if rt_tol is not None else None,
        linkage, distance_threshold, precursor_tol_mass, precursor_tol_mode,
        rt_tol, min_matches, fragment_tol, group_max, score_large, dev,
        counters="exact.linkage", eps_far=float(distance_threshold),
        **kwargs)
    profiler.add("wait for scores", linked.wait_s)
    profiler.add("linkage and refinement", linked.link_s)

    labels = np.full(n, -1, np.int32)
    labels[order[pos]] = linked.labels
    assign_global_cluster_labels(labels, order, splits, 0)
    # Medoids interval by interval: a lone spectrum represents itself, a
    # group gives its own (noise first).
    per_interval = sizes.copy()
    per_interval[grouped] = linked.n_medoids
    from_group = np.repeat(grouped, per_interval)
    medoids = np.empty(len(from_group), np.int64)
    medoids[from_group] = linked.medoids
    medoids[~from_group] = order[splits[:-1][sizes == 1]]
    noise_mask = labels == -1
    n_clusters = int(labels.max()) + 1 if n else 0
    n_noise = int(noise_mask.sum())
    logger.info(
        "%d spectra grouped in %d clusters, %d spectra remain as "
        "singletons",
        int((~noise_mask).sum()), n_clusters, n_noise,
    )
    # Reassign noise points to singleton clusters.
    labels[noise_mask] = np.arange(
        n_clusters, n_clusters + n_noise, dtype=np.int32
    )
    return labels, medoids

