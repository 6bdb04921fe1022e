"""Device selection shared by every entry point of the port.

The rule: run on the CUDA card unless the caller names another device.
With no card and no explicit request this raises instead of carrying on
on the host, because a CPU reading is never a device-health number.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """`device` as a `torch.device`; None means the current CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "host-side version explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def device_kind(device: torch.device) -> str:
    """Human-readable device name (the `device_kind` of reports)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
