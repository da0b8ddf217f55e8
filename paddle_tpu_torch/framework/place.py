"""Device resolution for the port's entry points.

Every entry point takes an explicit `device=`. The default is the CUDA
card; asking for it where there is none raises instead of carrying on
silently on the CPU. Tests pass `device="cpu"`."""
from __future__ import annotations

import torch

from .errors import UnavailableError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` -> "cuda"; a CUDA device is checked for presence."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise UnavailableError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev
