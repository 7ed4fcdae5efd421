"""The one device a run computes on.

Every op of the port takes an explicit ``device``.  A run resolves it once:
from the caller's argument, else from the ``FALCON_TPU_TORCH_DEVICE``
environment variable, else ``"cuda"``.  The CPU is used only when asked for
by name (the CPU tests do); asking for CUDA on a machine without a GPU is an
error, never a silent fall back to the CPU.
"""

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "FALCON_TPU_TORCH_DEVICE"


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """The run's device: ``device``, else ``$FALCON_TPU_TORCH_DEVICE``,
    else ``cuda``.  Raises ``RuntimeError`` for CUDA without a GPU."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Device {str(dev)!r} was requested but no CUDA GPU is "
            f"visible; set {DEVICE_ENV}=cpu to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU), so a host
    clock around it measures the work and not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
