"""A fixed-order group-by on the card (``csrc/groupby.cuh``,
``csrc/groupby.cu``), the routine under the medoid scores (B.1,
``ops/medoids.py``) and the consensus table (B.3, ``ops/consensus.py``).

Items with group ids ``key >> shift`` in ``[0, n_groups)`` (any other id
is a sink and is dropped) are put into ``off`` (``n_groups + 1``) and
``items`` (int32 original positions), each group's items in ascending
position: what a stable sort by group id gives, without one.  Integer
atomics count the groups, ``torch.cumsum`` scans the counts, atomics
claim the slots in no fixed order, and each group is then ordered by
position on its own: one thread's insertion sort up to ``SMALL`` items,
one warp's bitonic sort in shared memory up to ``WARP_CAP``, one block's
in global memory beyond.  B.1 and B.3 run the same steps with the order
step fused into their own kernels; :func:`group_by` runs them alone.
"""

import torch

from . import _build
from .pairwise import _check_launch, count_launch

SMALL = 16  # csrc/groupby.cuh GB_SMALL: one thread's insertion sort
WARP_CAP = 1024  # csrc/groupby.cu GB_WARP_CAP: one warp's bitonic sort


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def count_and_fill(key: torch.Tensor, n_groups: int, shift: int = 0,
                   cnt1: torch.Tensor = None, stream: int = None):
    """Steps 1-3 on the card, inside the caller's ``torch.cuda.device``:
    ``(off, items)``, each group's positions in its range of ``items``
    (length ``len(key)``, the tail past ``off[-1]`` unused) in no fixed
    order.  ``cnt1`` (``n_groups + 1``,
    int32): counts already taken at ``cnt1[group + 1]`` (step 1 skipped);
    it is consumed.  ``stream``: the launch stream (default: current)."""
    n = key.shape[0]
    dev = key.device
    lib = _build.library()
    if stream is None:
        stream = _stream(dev)
    if cnt1 is None:
        cnt1 = torch.zeros(n_groups + 1, dtype=torch.int32, device=dev)
        _check_launch("group_by", lib.falcon_groupby_count(
            key.data_ptr(), n, shift, n_groups, cnt1.data_ptr(), stream))
    off = torch.cumsum(cnt1, 0, dtype=torch.int32)
    items = torch.empty(n, dtype=torch.int32, device=dev)
    _check_launch("group_by", lib.falcon_groupby_fill(
        key.data_ptr(), n, shift, n_groups, off.data_ptr(), cnt1.data_ptr(),
        items.data_ptr(), stream))
    return off, items


def _check(key, n_groups, shift):
    if (not isinstance(key, torch.Tensor) or key.dtype != torch.int32
            or key.ndim != 1 or not key.is_contiguous()):
        raise ValueError("group_by: key must be a contiguous (n,) int32 "
                         "tensor")
    if not 0 <= shift < 32 or not 0 < n_groups < 2**31 - 1:
        raise ValueError("group_by: 0 <= shift < 32 and 0 < n_groups < "
                         "2**31 - 1")


def group_by(key: torch.Tensor, n_groups: int, shift: int = 0):
    """``(off (n_groups + 1,), items (off[-1],))``, int32: the positions
    of the items of each group ``key >> shift``, ascending."""
    _check(key, n_groups, shift)
    if key.device.type == "cpu":
        return group_by_plain(key, n_groups, shift)
    with torch.cuda.device(key.device):
        off, items = count_and_fill(key, n_groups, shift)
        _check_launch("group_by", _build.library().falcon_groupby_order(
            off.data_ptr(), n_groups, items.data_ptr(), _stream(key.device)))
    count_launch(group_by)
    return off, items[:int(off[-1])]


group_by.launches = 0


def group_by_plain(key: torch.Tensor, n_groups: int, shift: int = 0):
    """Plain PyTorch version of :func:`group_by` (any device): a stable
    sort by group id and a search for each group's start."""
    group = key.long() >> shift
    group = torch.where((group >= 0) & (group < n_groups), group, n_groups)
    sorted_group, items = torch.sort(group, stable=True)
    off = torch.searchsorted(sorted_group, torch.arange(
        n_groups + 1, device=key.device))
    return off.int(), items[:int(off[-1])].int()
