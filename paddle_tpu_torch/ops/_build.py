"""Build and load the hand-written CUDA kernels in `paddle_tpu_torch/csrc`.

Each `csrc/*.cu` file is compiled by `nvcc` into a shared library with a
plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/paddle_tpu_torch/<name>-<hash>.so <name>.cu

- The libraries go to the kernel build cache, `build_dir()`:
  `build/paddle_tpu_torch` unless `device.enable_compilation_cache` (or
  FLAGS_xla_compilation_cache_dir) names another directory; a library
  found there is loaded without a build.

- The build runs at the first CUDA launch, never at import, so the CPU
  test suite needs no `nvcc`.
- The library file name carries a hash of its source and the flags, so an
  edited kernel is rebuilt and a stale library is never loaded.
- `build()` starts one `nvcc` per source, all at once, and waits for all.
- Every C entry point takes its pointers and its stream as `void*`
  (`ctypes.c_void_p`) and returns `cudaGetLastError()`; `check()` raises
  on a non-zero code, so a refused launch is never silent.
- `function()` hands out a C entry with its ctypes signature set once,
  when it is first bound, so a launch does not set it again.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence, Tuple

__all__ = ["SOURCES", "build", "load", "function", "check", "build_dir",
           "default_build_dir", "set_build_dir", "source_hash",
           "ptxas_log"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("paged_attention.cu", "flash_fwd.cu", "flash_bwd_dq.cu",
           "flash_bwd_dkv.cu", "splash_fwd.cu", "splash_bwd_dq.cu",
           "splash_bwd_dkv.cu")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_funcs: Dict[Tuple[str, str], Any] = {}


_dir = None   # the kernel build cache (device.enable_compilation_cache)


def default_build_dir() -> Path:
    return _PKG.parent / "build" / "paddle_tpu_torch"


def set_build_dir(path) -> None:
    """Build and look up the libraries under `path` from now on (the
    libraries loaded so far stay loaded)."""
    global _dir
    _dir = Path(path)


def build_dir() -> Path:
    """The kernel build cache: `build/paddle_tpu_torch` in the checkout
    unless `device.enable_compilation_cache` (or its flag, resolved at
    the first build) chose another directory."""
    if _dir is None:
        from ..device import maybe_enable_compilation_cache
        maybe_enable_compilation_cache()
    return _dir if _dir is not None else default_build_dir()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of paddle_tpu_torch are built from source at first use")


def source_hash(src: str) -> str:
    """The hash a library of `src` is named by: its source, the shared
    headers and the nvcc flags."""
    text = (CSRC / src).read_bytes()
    for inc in sorted(CSRC.glob("*.cuh")):
        text += inc.read_bytes()
    return hashlib.sha256(text + " ".join(_FLAGS).encode()).hexdigest()[:16]


def _lib_path(src: str) -> Path:
    return build_dir() / f"{Path(src).stem}-{source_hash(src)}.so"


def ptxas_log(src: str) -> str:
    """What `-Xptxas -v` reported for `src` (registers, shared memory,
    spills) when it was built; empty if it was not built here."""
    log = _lib_path(src).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(sources: Iterable[str] = SOURCES) -> float:
    """Compile every missing library among `sources`, one `nvcc` each,
    all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [s for s in sources if not _lib_path(s).exists()]
        if not todo:
            return 0.0
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            p = subprocess.Popen(
                [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((src, out, tmp, p))
        errors = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            out.with_suffix(".log").write_text(log)
            if p.returncode != 0:
                errors.append(f"nvcc failed on {src} (rc {p.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(src: str) -> ctypes.CDLL:
    """The loaded library for `src`, built first if needed."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    build([src])
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _libs[src] = ctypes.CDLL(str(_lib_path(src)))
    return lib


def function(src: str, name: str, argtypes: Sequence[Any],
             restype: Any = ctypes.c_int) -> Any:
    """The C function `name` of `src`'s library, its ctypes signature
    set when it is first bound here and kept with it."""
    fn = _funcs.get((src, name))
    if fn is None:
        fn = getattr(load(src), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _funcs[(src, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
