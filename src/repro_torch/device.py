"""Device resolution and the card's identity.

Every entry point of the port takes a ``device`` argument.  ``None``
means the CUDA card; with no card that raises instead of moving to the
CPU, so a CPU run only happens when the caller asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` by default.

    Raises ``RuntimeError`` when a CUDA device is wanted (explicitly or
    by default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_identity(device: DeviceLike = None) -> str:
    """``"<name> x<count>"`` for a CUDA device, ``"cpu"`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return (f"{torch.cuda.get_device_name(dev)} "
            f"x{torch.cuda.device_count()}")


__all__ = ["resolve_device", "device_identity"]
