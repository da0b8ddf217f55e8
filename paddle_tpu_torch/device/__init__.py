"""paddle.device (port of `paddle_tpu.device`; reference
`python/paddle/device.py`): device selection and `device.cuda`, over
torch.cuda.

The JAX package's compilation-cache and program-store names
(`enable_compilation_cache`, `program_store_dir`, ...) have no
counterpart yet (ROADMAP A1): eager PyTorch has no per-shape compile to
cache, and `ops/_build.py` caches the kernels' nvcc builds."""
from __future__ import annotations

import torch

from ..framework.place import (CPUPlace, CUDAPlace, TPUPlace, device_count,
                               get_device, is_compiled_with_cuda,
                               is_compiled_with_tpu, resolve_device,
                               set_device)

__all__ = ["set_device", "get_device", "CPUPlace", "CUDAPlace", "TPUPlace",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "cuda"]


def _card(device):
    dev = resolve_device(device if device is not None else "cuda")
    return dev if dev.type == "cuda" else torch.device("cuda")


class cuda:
    """paddle.device.cuda.*: the CUDA card's counters and fences."""

    @staticmethod
    def device_count():
        return device_count()

    @staticmethod
    def synchronize(device=None):
        torch.cuda.synchronize(_card(device))

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def max_memory_allocated(device=None):
        if not torch.cuda.is_available():
            return 0
        return torch.cuda.max_memory_allocated(_card(device))

    @staticmethod
    def memory_allocated(device=None):
        if not torch.cuda.is_available():
            return 0
        return torch.cuda.memory_allocated(_card(device))
