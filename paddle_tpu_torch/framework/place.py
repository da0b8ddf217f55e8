"""Places and device selection (port of `paddle_tpu.framework.place`;
reference `paddle/fluid/platform/place.h` and `paddle.set_device`).

A `Place` names a device; `torch_device()` gives the `torch.device` it
stands for. The default place is thread-local, as the JAX package's
`_State` is. Unlike the JAX package, whose `_auto_place` falls back to
the CPU when no accelerator is present, the default here is the CUDA
card `gpu:0`: every entry point resolves its device through
`resolve_device`, which raises UnavailableError where there is no card.
`set_device("cpu")` (or `place=CPUPlace()` on one call) is how a caller
asks for the CPU. `TPUPlace`, `XPUPlace` and `NPUPlace` keep their names
for code written against the reference; resolving one raises, and
`set_device("tpu")` raises.
"""
from __future__ import annotations

import threading

import torch

from .errors import InvalidArgumentError, UnavailableError

__all__ = [
    "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
    "XPUPlace", "NPUPlace", "set_device", "get_device", "default_place",
    "resolve_device", "is_compiled_with_cuda", "is_compiled_with_tpu",
    "is_compiled_with_xpu", "is_compiled_with_npu", "device_count",
    "get_cudnn_version",
]


class Place:
    """Names a device; `torch_device()` resolves it."""

    kind = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        raise UnavailableError(
            f"{self!r}: the PyTorch port runs on the CPU and CUDA cards "
            f"only; use CUDAPlace or CPUPlace")

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    kind = "gpu"

    def torch_device(self):
        return _checked(torch.device("cuda", self.device_id))


class CUDAPinnedPlace(Place):
    """Pinned host memory: tensors live on the CPU (`pin_memory()` is the
    caller's choice)."""
    kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "CUDAPinnedPlace"


class TPUPlace(Place):
    kind = "tpu"


class XPUPlace(Place):
    kind = "xpu"


class NPUPlace(XPUPlace):
    kind = "npu"


def _checked(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise UnavailableError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (or set_device('cpu')) to run the "
            f"plain PyTorch path")
    return dev


class _State(threading.local):
    def __init__(self):
        self.place: Place = CUDAPlace(0)


_state = _State()


def default_place() -> Place:
    return _state.place


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: `device` (a str, a
    torch.device or a Place), or the thread's default place when None
    (the CUDA card unless `set_device` chose another). A CUDA device is
    checked for presence."""
    if device is None:
        device = _state.place
    if isinstance(device, Place):
        return device.torch_device()
    return _checked(torch.device(device))


def set_device(device) -> Place:
    """paddle.set_device('cpu' | 'gpu' | 'gpu:1' | 'cuda:0' | a Place).
    The place is checked when it is used, not here."""
    if isinstance(device, Place):
        place = device
    else:
        name, _, idx = str(device).partition(":")
        idx = int(idx) if idx else 0
        name = name.lower()
        if name == "cpu":
            place = CPUPlace()
        elif name in ("gpu", "cuda"):
            place = CUDAPlace(idx)
        elif name in ("tpu", "xpu", "npu"):
            raise UnavailableError(
                f"set_device({device!r}): the PyTorch port runs on the CPU "
                f"and CUDA cards only")
        else:
            raise InvalidArgumentError(f"Unknown device {device!r}")
    _state.place = place
    return place


def get_device() -> str:
    p = _state.place
    if isinstance(p, (CPUPlace, CUDAPinnedPlace)):
        return "cpu"
    return f"{p.kind}:{p.device_id}"


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def device_count() -> int:
    """The CUDA cards torch sees."""
    return torch.cuda.device_count()


def get_cudnn_version():
    """cuDNN's version as an int, or None without CUDA."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()
