"""Density clustering (DBSCAN) over the sparse neighbour lists, in PyTorch.

Port of ``falcon_tpu/ops/density.py::dbscan``, the same semantics: a core
point has at least ``min_samples`` points within ``eps`` (itself
included); clusters are the connected components of the core-core
eps-graph; a border point joins its most similar core neighbour (the first
on a tie); components of fewer than two members become noise.

Components come from min-label propagation on the device, as in the JAX
package: gather the neighbours' labels for out-edges, and the smallest
label among the rows that list a row for its in-edges (so the one-sided
top-k lists act as an undirected graph), then two pointer jumps, until
nothing changes or ``n_pad`` rounds have run.  The JAX package scatters
the in-edges with a min; here they are grouped by target once (a sort)
and reduced per target with ``segment_reduce``, so no scatter runs on the
card.  The JAX package runs this as XLA; every step here is a plain torch
op.  Only the compact per-row parts come to the
host, where ``labels_from_parts`` (a copy of the JAX package's NumPy
function) numbers the components.
"""

import numpy as np
import torch

from .knn import NEG
from .matching import f32_tolerance


def dbscan(sims: torch.Tensor, neigh: torch.Tensor, eps: float, n: int,
           min_samples: int) -> np.ndarray:
    """DBSCAN labels for the first ``n`` rows; -1 marks noise.

    ``sims`` (n_pad, k) float32 and ``neigh`` (n_pad, k) int64 (-1 =
    none) are the k-NN stage's padded lists, on any device.  Components
    are numbered by first occurrence.
    """
    n_pad, k = sims.shape
    device = sims.device
    row = torch.arange(n_pad, device=device)
    in_range = row < n
    valid = (neigh >= 0) & in_range[:, None]
    within = valid & ((1.0 - sims) <= f32_tolerance(eps))
    neigh_safe = neigh.clamp(0, n_pad - 1)
    core = ((within.sum(dim=1) + 1) >= min_samples) & in_range
    edge = within & core[:, None] & core[neigh_safe]

    labels = torch.where(core, row, n_pad)
    # In-edges grouped by target: the source rows, and each row's count
    # (non-edges take target n_pad and sort last).
    target, order = torch.sort(torch.where(edge, neigh_safe, n_pad)
                               .reshape(-1))
    off = torch.searchsorted(target, torch.arange(n_pad + 1, device=device))
    src = order[:int(off[-1])] // k
    in_degree = off[1:] - off[:-1]
    for _ in range(n_pad):
        # Out-edges: the smallest neighbour label.
        new = torch.minimum(
            labels,
            torch.where(edge, labels[neigh_safe], n_pad).amin(dim=1))
        # In-edges: the smallest label among the rows that list this one
        # (labels are row ids, exact in float64).
        if src.numel():
            incoming = torch.segment_reduce(
                labels[src].double(), "min", lengths=in_degree,
                unsafe=True, initial=float(n_pad))
            new = torch.minimum(new, incoming.long())
        # Pointer jumping: a label is a row id, so label[label[x]] is in
        # x's component too.
        new = torch.minimum(new, new[new.clamp_max(n_pad - 1)])
        new = torch.minimum(new, new[new.clamp_max(n_pad - 1)])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    comp = torch.where(core, labels, -1)

    core_neigh = within & core[neigh_safe]
    best_pos = torch.argmax(torch.where(core_neigh, sims, NEG), dim=1)
    best_id = torch.gather(neigh, 1, best_pos[:, None])[:, 0]
    attach = torch.where(core_neigh.any(dim=1) & ~core & in_range, best_id,
                         -1)
    return labels_from_parts(comp[:n].cpu().numpy(), core[:n].cpu().numpy(),
                             attach[:n].cpu().numpy(), n)


def labels_from_parts(
    comp: np.ndarray, core: np.ndarray, border_attach: np.ndarray, n: int
) -> np.ndarray:
    """Host renumbering of the device kernel's compact outputs.

    Shared by the single-device path above and the multi-chip pipeline
    (``parallel/sharded_pipeline.py``) so both produce identical labels
    from identical (comp, core, border) parts.
    """
    # Renumber core components by first occurrence.
    labels = np.full(n, -1, np.int64)
    if core.any():
        uniq, inverse = np.unique(comp[core], return_inverse=True)
        # np.unique sorts by component id == min member row == first
        # occurrence order (rows are scanned in order).
        labels[core] = inverse
    # Border attachment.
    attach = border_attach >= 0
    labels[attach] = labels[border_attach[attach]]
    # Drop single-member components to noise.
    uniq, counts = np.unique(labels[labels >= 0], return_counts=True)
    singles = uniq[counts < 2]
    if len(singles):
        labels[np.isin(labels, singles)] = -1
    return labels
