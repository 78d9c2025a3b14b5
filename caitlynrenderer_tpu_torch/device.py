"""Device selection.  Asking for a device that is not there raises: a run
that asked for the card never falls back to the CPU."""

from __future__ import annotations

import torch


def get_device(name: str = "cuda") -> torch.device:
    """`torch.device` for `name` ("cuda", "cuda:1", "cpu").  Raises
    RuntimeError for a CUDA device when no card is visible."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        index = dev.index or 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (expected cuda or cpu)")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA device; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
