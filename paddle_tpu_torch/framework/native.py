"""Build and load the host-side C++ libraries in `paddle_tpu_torch/csrc`.

The parameter server's tables (`ps_core.cc`) and the slot-file parser
(`data_feed.cc`) are plain C++ with a C interface, loaded with `ctypes`:

    g++ -O2 -fPIC -std=c++17 -shared [-pthread] -o
        build/paddle_tpu_torch/<name>-<hash>.so <name>.cc

- The build runs at first use, never at import.
- The file name carries a hash of the source and the flags, so an edited
  source is rebuilt and a stale library is never loaded (as
  `ops/_build.py` names the nvcc builds).
- Each build writes a name of its own (the process id in it) and
  `os.replace`s it into place, so processes that build at once do not
  race.
- A failed build raises; nothing falls back to another library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
FLAGS = {"ps_core.cc": ["-O2", "-fPIC", "-std=c++17", "-shared"],
         "data_feed.cc": ["-O2", "-fPIC", "-std=c++17", "-shared",
                          "-pthread"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    return _PKG.parent / "build" / "paddle_tpu_torch"


def lib_path(src: str) -> Path:
    key = hashlib.sha256((CSRC / src).read_bytes()
                         + " ".join(FLAGS[src]).encode()).hexdigest()[:16]
    return _build_dir() / f"{Path(src).stem}-{key}.so"


def _compile(src: str, out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *FLAGS[src], "-o", str(tmp), str(CSRC / src)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {src} (rc {p.returncode}):\n"
                           f"{p.stdout}")
    os.replace(tmp, out)


def load(src: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<src>`, built first if needed."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            out = lib_path(src)
            if not out.exists():
                _compile(src, out)
            lib = _libs[src] = ctypes.CDLL(str(out))
        return lib
