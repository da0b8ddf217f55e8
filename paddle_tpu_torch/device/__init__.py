"""paddle.device (port of `paddle_tpu.device`; reference
`python/paddle/device.py`): device selection and `device.cuda`, over
torch.cuda.

Also the port's two caches under the JAX package's names:

- **The compilation cache** is the kernel build cache: the directory
  where `ops/_build.py` writes and looks up its `nvcc` libraries, the
  port's only compile. By default `build/paddle_tpu_torch` in the
  checkout; `enable_compilation_cache(path)` (or
  FLAGS_xla_compilation_cache_dir, read at the first build by
  `maybe_enable_compilation_cache`) points it elsewhere, so a fresh
  process or checkout that finds the libraries there runs no `nvcc`.
  With no CUDA device there is nothing to cache: both return None.
- **The serving program store** (`serving/program_store.py`) resolves
  its root through `program_store_dir()` (FLAGS_gen_program_store_dir).

Both consult one gate, `serialization_unsafe_backend()`: may a program
loaded from disk be trusted to keep writing its inputs in place? The
JAX package answers True on XLA:CPU, whose deserialized executables
dropped their donation aliasing. The port's artifact is a
`torch.export` program, whose graph keeps its in-place writes through
`torch.export.save` / `load` on the CPU and on the card alike
(`tests/test_torch_program_store.py`, chip_smoke's phase store), so the
port answers False everywhere (ROADMAP C45). A forced override warns
once either way, and the store's self-check runs on every load."""
from __future__ import annotations

import os as _os
import warnings as _warnings

import torch

from ..framework.place import (CPUPlace, CUDAPlace, TPUPlace, device_count,
                               get_device, is_compiled_with_cuda,
                               is_compiled_with_tpu, resolve_device,
                               set_device)

__all__ = ["set_device", "get_device", "CPUPlace", "CUDAPlace", "TPUPlace",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "cuda", "enable_compilation_cache",
           "maybe_enable_compilation_cache", "compilation_cache_dir", "serialization_unsafe_backend",
           "warn_forced_serialization", "program_store_dir"]

_cache_decision_pending = True  # resolved at the first kernel build
_force_warned = False  # one warning a process, for both policies


def serialization_unsafe_backend() -> bool:
    """The gate of the program store and the compilation cache: True
    where a program loaded from disk cannot be trusted to keep writing
    its inputs in place. The port's `torch.export` programs keep their
    in-place writes through a save / load round trip on the CPU and on
    the card, so this is False (the JAX package's is True on XLA:CPU,
    ROADMAP C45)."""
    return False


def warn_forced_serialization(context: str) -> None:
    """One warning a process when a caller overrides the gate
    (`force=True`), naming the corruption class it guards against;
    shared by the compilation cache and the program store."""
    global _force_warned
    if _force_warned:
        return
    _force_warned = True
    _warnings.warn(
        f"{context}: forcing the reuse of programs loaded from disk where "
        f"device.serialization_unsafe_backend() says they may drop their "
        f"in-place writes (the aliasing-drop corruption class: a program "
        f"that should write the KV pools in place writes copies, so "
        f"later reads see stale pools); every load therefore runs the "
        f"in-place self-check and a numeric smoke probe, and falls back "
        f"to an export on any mismatch.", RuntimeWarning, stacklevel=3)


def enable_compilation_cache(path=None, force=False):
    """Point the kernel build cache at `path` (default
    FLAGS_xla_compilation_cache_dir, else `build/paddle_tpu_torch`):
    `ops/_build.py` writes and looks up its nvcc libraries there from
    now on. Returns the active directory, or None with no CUDA device
    (nothing to cache), or where the gate refuses and `force` is not
    set."""
    global _cache_decision_pending
    from ..framework.flags import flag
    from ..ops import _build
    _cache_decision_pending = False
    if not torch.cuda.is_available():
        return None
    if serialization_unsafe_backend():
        if not force:
            return None
        warn_forced_serialization("enable_compilation_cache(force=True)")
    d = path or str(flag("FLAGS_xla_compilation_cache_dir") or "").strip()
    d = _os.path.abspath(_os.path.expanduser(d)) if d \
        else str(_build.default_build_dir())
    try:
        _os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    _build.set_build_dir(d)
    return d


def compilation_cache_dir():
    """The directory of the kernel build cache in use (None with no CUDA
    device)."""
    if not torch.cuda.is_available():
        return None
    from ..ops import _build
    return str(_build.build_dir())


def program_store_dir():
    """Root directory configured for the serving program store
    (FLAGS_gen_program_store_dir, expanded; None when unset = store
    off)."""
    from ..framework.flags import flag
    d = str(flag("FLAGS_gen_program_store_dir") or "").strip()
    return _os.path.expanduser(d) if d else None


def maybe_enable_compilation_cache():
    """Resolve the cache directory once, at the first kernel build
    (`ops/_build.py` calls this): FLAGS_xla_compilation_cache on and
    FLAGS_xla_compilation_cache_dir set point the build cache there.
    Idempotent and cheap after the first call."""
    global _cache_decision_pending
    if not _cache_decision_pending:
        return
    _cache_decision_pending = False
    from ..framework.flags import flag
    if flag("FLAGS_xla_compilation_cache") \
            and str(flag("FLAGS_xla_compilation_cache_dir") or "").strip():
        enable_compilation_cache()


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
