"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "sync"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one. ``None`` means ``"cuda"``; asking for a CUDA device on
    a host without one raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def sync(device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a CUDA device, nothing elsewhere (CPU ops run in order)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
