"""Pair-sharded exact condensed distances for the exact backend.

Port of ``falcon_tpu/parallel/sharded_exact.py``: the condensed upper
triangle of one large precursor interval, n(n-1)/2 pairs, is cut into
``mesh.size`` equal contiguous slices, one per shard, with the interval's
peaks replicated (one copy to each device).  Each shard scores the rows its
slice touches with the panel kernel (K1, ``ops/pairwise.py::panel_scores``,
``upper_only=True``) in panels of at most ``panel_rows`` rows against every
column, keeps exactly its slice (its first and last rows cut where the
slice starts or ends inside them) and copies only that slice to the host,
already in condensed order.  K1 takes the panel row as the JAX package's
``mz_a``, here the pair's i < j, so each pair's bits are those of the JAX
package's ``pair_weights`` / ``match_score`` on (i, j).

The JAX package scores its slices in chunks of ``pair_chunk`` condensed
indices whose (i, j) a ``searchsorted`` finds on the device; the chunking
changes neither a pair's score nor the condensed order, so the port takes
K1's row panels instead.  On a mesh of virtual shards of one device the
shards run one after another.
"""

from typing import Optional

import numpy as np
import torch

from ..ops.matching import DEFAULT_ROUNDS
from ..ops.pairwise import panel_scores
from ..utils.profiling import profiler
from .mesh import Mesh, _replicated

# Condensed pair indices are int32 on the JAX package's devices; n(n-1)/2
# must fit.  Above it the caller takes the one-device path, as there.
MAX_N = 65536  # 65536 * 65535 / 2 = 2_147_450_880 < 2^31


def condensed_offsets(n: int) -> np.ndarray:
    """Row-start offsets into the condensed upper triangle.

    ``offsets[i]`` is the condensed index of pair (i, i+1);
    ``offsets[n] == n(n-1)/2``.  Row i owns ``n-1-i`` pairs.
    """
    rows = np.arange(n + 1, dtype=np.int64)
    return rows * (n - 1) - rows * (rows - 1) // 2


def _slice_distances(mz: torch.Tensor, intensity: torch.Tensor, offs,
                     k0: int, k1: int, fragment_tol: float,
                     min_matches: int, rounds: int, panel_rows: int,
                     out: np.ndarray) -> None:
    """Condensed pairs [k0, k1) of the interval whose peaks ``mz`` /
    ``intensity`` (n, P) lie on one device, written into ``out[k0:k1]`` as
    1 - score (0 where fewer than ``min_matches`` peaks matched)."""
    n = mz.shape[0]
    dev = mz.device
    cols = torch.arange(n, device=dev)
    with_matches = min_matches > 0
    i0 = int(np.searchsorted(offs, k0, side="right")) - 1
    i1 = int(np.searchsorted(offs, k1 - 1, side="right"))  # rows [i0, i1)
    for r0 in range(i0, i1, panel_rows):
        r1 = min(r0 + panel_rows, i1)
        with profiler.phase("score panels (K1)"):
            scores, matches = panel_scores(
                mz[r0:r1], intensity[r0:r1], mz, intensity, r0,
                fragment_tol, rounds, upper_only=True,
                with_matches=with_matches)
        with profiler.phase("panels to host"):
            if with_matches:
                scores = torch.where(matches >= min_matches, scores, 0.0)
            upper = cols[None, :] > (
                r0 + torch.arange(r1 - r0, device=dev))[:, None]
            # The panel's pairs are condensed [offs[r0], offs[r1]); keep
            # the part inside the slice.
            a, b = max(k0, int(offs[r0])), min(k1, int(offs[r1]))
            lo = a - int(offs[r0])
            segment = (1.0 - scores[upper][lo:lo + b - a]).cpu().numpy()
            out[a:b] = segment


def condensed_distances_sharded(
    mz_pad: np.ndarray,
    int_pad: np.ndarray,
    fragment_tol: float,
    min_matches: int,
    mesh: Mesh,
    rounds: int = DEFAULT_ROUNDS,
    panel_rows: int = 2048,
) -> Optional[np.ndarray]:
    """Condensed distance matrix of one interval, its pairs over ``mesh``.

    The contract of ``ops/pairwise.py::condensed_distances``: the float32
    condensed upper triangle of ``1 - score``, a score with fewer than
    ``min_matches`` matched peaks counting as 0; zeros(0) for n < 2; None
    above ``MAX_N`` spectra (the caller then takes the one-device path)."""
    n = mz_pad.shape[0]
    if n < 2:
        return np.zeros(0, np.float32)
    if n > MAX_N:
        return None
    m = n * (n - 1) // 2
    offs = condensed_offsets(n)
    mz_host = torch.from_numpy(np.ascontiguousarray(mz_pad, np.float32))
    int_host = torch.from_numpy(np.ascontiguousarray(int_pad, np.float32))
    # The replicated peaks: one copy to each distinct device.
    mz_rep = _replicated(mesh, lambda d: mz_host.to(d))
    int_rep = _replicated(mesh, lambda d: int_host.to(d))
    out = np.empty(m, np.float32)
    per = -(-m // mesh.size)
    for d in range(mesh.size):
        k0, k1 = d * per, min((d + 1) * per, m)
        if k0 < k1:
            _slice_distances(mz_rep[d], int_rep[d], offs, k0, k1,
                             fragment_tol, min_matches, rounds, panel_rows,
                             out)
    return out
