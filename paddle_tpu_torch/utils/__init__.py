"""paddle.utils (port of `paddle_tpu.utils`; reference
`python/paddle/utils/`). `utils.cpp_extension` (host C++ ops built with
g++) is imported by its path, as the JAX package's is."""
from . import download, unique_name  # noqa: F401
from .download import get_weights_path_from_url  # noqa: F401
from .lazy_import import try_import  # noqa: F401
from .log_writer import LogWriter  # noqa: F401

__all__ = ["download", "get_weights_path_from_url", "try_import",
           "unique_name", "deprecated", "run_check", "LogWriter"]


def deprecated(update_to="", since="", reason=""):
    """Decorator: calling the function warns DeprecationWarning."""
    def deco(fn):
        import functools
        import warnings

        @functools.wraps(fn)
        def wrapper(*a, **k):
            warnings.warn(f"{fn.__name__} is deprecated since {since}: "
                          f"{reason}; use {update_to}", DeprecationWarning)
            return fn(*a, **k)
        return wrapper
    return deco


def run_check():
    """Run a 2 x 2 matmul on the default device (the card unless
    `set_device` chose another), check it, print the device it ran on
    and return the device's name."""
    import torch

    from ..framework.place import resolve_device
    dev = resolve_device(None)
    x = torch.ones((2, 2), device=dev)
    y = float((x @ x).sum())
    if y != 8.0:
        raise RuntimeError(f"run_check: ones(2, 2) @ ones(2, 2) summed to "
                           f"{y} on {dev}, not 8")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"paddle_tpu_torch is installed successfully! ran a matmul on "
          f"{dev} ({name})")
    return name
