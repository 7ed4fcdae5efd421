"""The IVF self-search over a device mesh: query lists resident, corpus
slabs rotating around a ring.

Port of ``falcon_tpu/parallel/sharded_ivf.py``.  The index's
``(n_lists, lb, D)`` slab layout shards on the list axis, ``n_lists / N``
lists a shard (None when N does not divide the list count; the caller then
takes the one-device search).  Each shard keeps its query lists (the rank
slabs where the index has them, else the corpus slabs) and their m/z and
rows; the corpus slabs, their m/z and their rows rotate: at ring step s
shard ``me`` holds corpus block ``(me + s) % N`` and passes it to shard
``me - 1`` (``ppermute``) for the next step.

At each step every local query list runs IVF.1 (``ops/ivf.py::
probe_topk``, ``csrc/ivf.cu``) over its ``n_probe`` probes, and the probes
outside the held block are masked, as the JAX package's ``ppm`` masks them:
each rotating block carries one more list, of +inf m/z, and a probe outside
the block points at it, so none of its positions is in band.  A kept slot
is ``probe * lb + b`` of the whole layout, and a stable top-k over
[running best, this step] merges the step into the running best, ties to
the running best.  So the lists are the JAX package's sharded ones: their
tie order depends on the shard and can differ from the one-device search's.
The slots become rows and the rows go to row order by gathers on the card.
"""

from typing import List, Optional, Tuple

import torch

from ..ops.ivf import NEG, probe_topk, scan_chunk
from ..ops.knn import stable_topk
from ..ops.matching import f32_tolerance
from .mesh import Mesh, ppermute, shard_rows


def _blocks_with_sentinel(mesh: Mesh, slabs: torch.Tensor, mz: torch.Tensor,
                          rows: torch.Tensor):
    """Per shard, its corpus block of lists and one more list of zero
    vectors, m/z +inf and row -1 (the masked probes' list)."""
    out = []
    for parts, fill in ((shard_rows(mesh, slabs), 0.0),
                        (shard_rows(mesh, mz), torch.inf),
                        (shard_rows(mesh, rows), -1)):
        out.append([torch.cat([p, p.new_full((1,) + p.shape[1:], fill)])
                    for p in parts])
    return out


def ivf_search_sharded(
    index,
    k: int,
    n_probe: int,
    tol_mass: float,
    tol_mode: str,
    mesh: Mesh,
    precise: bool = False,
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Sharded self-search of ``index`` (an ``ops.ivf.IVFIndex``): the
    contract of ``index.self_search``, (n, k) float32 similarities and int32
    row ids on ``mesh.devices[0]``, -2 / -1 where missing, ranked by the
    index's rank vectors where it has them.  ``precise`` scans float32
    slabs, else bfloat16 ones (float32 sums).  Returns None when the mesh
    does not divide the list count."""
    n_dev = mesh.size
    n_lists = index.n_lists
    if n_dev > n_lists or n_lists % n_dev != 0:
        return None
    n_probe = min(n_probe, n_lists)
    lb = index._lb
    s_lists = n_lists // n_dev
    k_eff = min(k, n_probe * lb)
    scan_dtype = torch.float32 if precise else torch.bfloat16
    tol, tol_is_da = f32_tolerance(tol_mass), tol_mode == "Da"
    q3d = index._query3d if index._query3d is not None else index._corpus3d
    # Resident: each shard's query lists, their m/z, rows and probes.
    q_s = shard_rows(mesh, q3d.to(scan_dtype).contiguous())
    qm_s = shard_rows(mesh, index._mz3d)
    qr_s = shard_rows(mesh, index._row3d)
    probes_s = shard_rows(mesh, torch.from_numpy(
        index._probe_ids(n_probe)).to(index._device))
    # Rotating: the corpus blocks.
    cc, ccm, ccr = _blocks_with_sentinel(
        mesh, index._corpus3d.to(scan_dtype).contiguous(), index._mz3d,
        index._row3d)
    chunk = scan_chunk(s_lists, lb, n_probe, lb)
    best_s: List[torch.Tensor] = [
        torch.full((s_lists * lb, k_eff), NEG, device=d)
        for d in mesh.devices]
    best_slot: List[torch.Tensor] = [
        torch.full((s_lists * lb, k_eff), -1, dtype=torch.int32, device=d)
        for d in mesh.devices]
    to_left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    for step in range(n_dev):
        for me in range(n_dev):
            lo = ((me + step) % n_dev) * s_lists
            probes = probes_s[me]
            held = (probes >= lo) & (probes < lo + s_lists)
            local = torch.where(held, probes - lo, s_lists).int().contiguous()
            parts = [probe_topk(q_s[me], qm_s[me], qr_s[me], cc[me], ccm[me],
                                ccr[me], local, tol, tol_is_da, k_eff, c0,
                                chunk)
                     for c0 in range(0, s_lists, chunk)]
            ts = torch.cat([s for s, _ in parts]).view(-1, k_eff)
            slot = torch.cat([i for _, i in parts]).view(-1, k_eff)
            slot = torch.where(slot >= 0, slot + lo * lb, -1)
            top, pos = stable_topk(torch.cat([best_s[me], ts], dim=1), k_eff)
            best_s[me] = top
            best_slot[me] = torch.gather(
                torch.cat([best_slot[me], slot], dim=1), 1, pos)
        if step + 1 < n_dev:
            cc = ppermute(mesh, cc, to_left)
            ccm = ppermute(mesh, ccm, to_left)
            ccr = ppermute(mesh, ccr, to_left)
    home = mesh.devices[0]
    scores = torch.cat([s.to(home) for s in best_s])
    slots = torch.cat([s.to(home) for s in best_slot])
    row_of_slot = index._row3d.view(-1).to(home)
    rows = torch.where(slots >= 0, row_of_slot[slots.clamp_min(0).long()],
                       -1)
    slot_of_row = index._slot_of_row.to(home)
    out_s, out_i = scores[slot_of_row], rows[slot_of_row]
    if k_eff < k:
        n = out_s.shape[0]
        out_s = torch.cat([out_s, out_s.new_full((n, k - k_eff), NEG)], dim=1)
        out_i = torch.cat([out_i, out_i.new_full((n, k - k_eff), -1)], dim=1)
    return out_s, out_i
