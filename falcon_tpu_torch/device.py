"""The devices a run computes on.

Every op of the port takes an explicit ``device``.  A run resolves it once:
from the caller's argument, else from the ``FALCON_TPU_TORCH_DEVICE``
environment variable, else ``"cuda"``.  The CPU is used only when asked for
by name (the CPU tests do); asking for CUDA on a machine without a GPU is an
error, never a silent fall back to the CPU.

``visible_devices`` is the one place that counts the devices a ``--devices
N`` run may shard over: every CUDA card, or the CPU once.  With
``FALCON_TPU_TORCH_VIRTUAL_DEVICES=N`` it returns N shards of the run's one
device instead, so the sharded path runs on the CPU tests and on one card,
as ``--xla_force_host_platform_device_count`` gives JAX eight CPU devices.
Tests and ``chip_smoke.py`` set it; the CLI never does.
"""

import contextlib
import os
from typing import Iterator, List, Optional, Union

import torch

DEVICE_ENV = "FALCON_TPU_TORCH_DEVICE"
VIRTUAL_DEVICES_ENV = "FALCON_TPU_TORCH_VIRTUAL_DEVICES"


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


def visible_devices(dev: torch.device) -> List[torch.device]:
    """The devices a sharded run of ``dev``'s type may use, in mesh order:
    ``$FALCON_TPU_TORCH_VIRTUAL_DEVICES`` shards of ``dev`` where that is
    set, else ``cuda:0 .. count - 1`` on CUDA, else ``dev`` once."""
    virtual = os.environ.get(VIRTUAL_DEVICES_ENV)
    if virtual:
        if int(virtual) < 1:
            raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be >= 1, got "
                             f"{virtual!r}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * int(virtual)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on the calling thread's current stream of
    ``device`` (no-op on the CPU), so a host clock around it measures that
    work and not its enqueueing.  Other streams (another block's worker)
    are not waited for."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@contextlib.contextmanager
def worker_stream(device: torch.device) -> Iterator[None]:
    """Run the body on ``device`` with a stream of its own (CUDA; nothing
    on the CPU): the current device and stream are the calling thread's,
    so a worker thread enters this before it launches anything.  Waits for
    the stream on exit."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device)
        # Work queued before the worker started (uploads of shared
        # tensors) is on the device's current stream: wait for it.
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            try:
                yield
            finally:
                stream.synchronize()
