"""Upload of a block's padded peaks to the device.

Port of ``falcon_tpu/ops/xfer.py::upload_padded_peaks``: the same
``(n_rows, pad_to)`` float32 layout (padding m/z -1e6, intensity 0, rows
beyond the block all padding).  The JAX package uploads the ragged peaks
and pads them on the device, and slices large uploads
(``device_put_chunked``), both to save bytes on a TPU host link measured at
tens of MB/s; a PCIe link to an H100 has no such limit, so the port pads on
the host with the shared ``store.padded_peaks`` and copies from pinned
memory.
"""

from typing import Tuple

import numpy as np
import torch

from falcon_tpu.store.store import padded_peaks


def upload_padded_peaks(
    offsets: np.ndarray,
    mz_flat: np.ndarray,
    intensity_flat: np.ndarray,
    row_indices: np.ndarray,
    pad_to: int,
    n_rows: int,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged peaks of ``row_indices`` -> (n_rows, pad_to) float32 m/z and
    intensity tensors on ``device``."""
    if len(row_indices) > n_rows:
        raise ValueError(f"{len(row_indices)} rows do not fit n_rows="
                         f"{n_rows}")
    mz, intensity, _ = padded_peaks(offsets, mz_flat, intensity_flat, pad_to,
                                    row_indices)
    out = []
    for host, fill in ((mz, -1e6), (intensity, 0.0)):
        full = torch.full((n_rows, pad_to), fill, dtype=torch.float32,
                          pin_memory=device.type == "cuda")
        full[:host.shape[0]] = torch.from_numpy(host)
        out.append(full.to(device, non_blocking=True))
    return out[0], out[1]
