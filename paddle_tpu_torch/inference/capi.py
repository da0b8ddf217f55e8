"""Build the port's C inference API, `libpd_infer_capi.so` (the C side
is `paddle_tpu_torch/csrc/{pd_c_api.h,inference_capi.cc}`; the JAX
package's counterpart is `csrc/` with its Makefile).

    from paddle_tpu_torch.inference import capi
    lib = capi.build()        # build/paddle_tpu_torch/capi-<hash>/
    # gcc main.c -I<capi.CSRC> -L<lib.parent> -lpd_infer_capi \\
    #     -Wl,-rpath,<lib.parent>

- The library builds with `g++` at first use, never at import, with the
  flags of `python3-config --includes` and `python3-config --embed
  --ldflags` of the running Python (the `python3-config` beside
  `sys.executable`, else the one on PATH; without one, the same flags
  from `sysconfig`), and an rpath to its libpython.
- It embeds CPython. The running interpreter's `sys.executable` and the
  directory that holds this package are compiled in
  (`PD_PYTHON_EXECUTABLE`, `PD_PACKAGE_ROOT`): the embedded interpreter
  takes that executable as its program name, so it finds the same prefix
  and site-packages (torch, numpy; a venv's too), and imports this
  package from this checkout without PYTHONPATH.
- The directory name carries a hash of the sources and the flags, so an
  edited source or another Python gets a library of its own, and the
  file keeps the name `libpd_infer_capi.so` that `-lpd_infer_capi`
  links. Each build writes a name of its own and `os.replace`s it into
  place (as `framework/native.py`); a failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List

__all__ = ["CSRC", "build", "library_path", "python_config"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("inference_capi.cc", "pd_c_api.h")
_lock = threading.Lock()


def python_config() -> str:
    """The `python3-config` of the running Python: the one beside
    `sys.executable`, else the one on PATH; raises where there is none."""
    exe_dir = Path(sys.executable).parent
    for name in (f"python{sys.version_info[0]}.{sys.version_info[1]}"
                 "-config", "python3-config"):
        cand = exe_dir / name
        if cand.is_file():
            return str(cand)
    found = shutil.which("python3-config")
    if found is None:
        raise RuntimeError("python3-config not found: the C API build "
                           "needs the Python development files")
    return found


def _python_flags():
    """(include flags, embedding link flags): `python3-config
    --includes` and `--embed --ldflags`; where the running Python has no
    python3-config, the same flags from its `sysconfig`."""
    try:
        cfg = python_config()
    except RuntimeError:
        var = sysconfig.get_config_var
        return ([f"-I{sysconfig.get_paths()['include']}"],
                [f"-L{var('LIBDIR')}", f"-lpython{var('LDVERSION')}"]
                + (var("LIBS") or "").split()
                + (var("SYSLIBS") or "").split())

    def out(*args):
        return subprocess.run([cfg, *args], check=True, text=True,
                              stdout=subprocess.PIPE).stdout.split()
    return out("--includes"), out("--embed", "--ldflags")


def _flags() -> List[str]:
    includes, ldflags = _python_flags()
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    return (["-O2", "-fPIC", "-std=c++17", "-shared",
             f'-DPD_PYTHON_EXECUTABLE="{sys.executable}"',
             f'-DPD_PACKAGE_ROOT="{_PKG.parent}"']
            + includes + ["@SRC@"] + ldflags
            + ([f"-Wl,-rpath,{libdir}"] if libdir else []))


def library_path() -> Path:
    """Where this checkout's library is (built or not)."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(_flags()).encode())
    return (_PKG.parent / "build" / "paddle_tpu_torch"
            / f"capi-{h.hexdigest()[:16]}" / "libpd_infer_capi.so")


def build() -> Path:
    """The library's path, built first if needed."""
    with _lock:
        out = library_path()
        if out.exists():
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        args = [str(CSRC / "inference_capi.cc") if a == "@SRC@" else a
                for a in _flags()]
        p = subprocess.run([cxx, *args, "-o", str(tmp)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on inference_capi.cc "
                               f"(rc {p.returncode}):\n{p.stdout}")
        os.replace(tmp, out)
        return out
