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

Not ported: ``_local_step`` and ``multichip_cluster_step``.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device, visible_devices


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
