"""Custom C++ op extension (port of `paddle_tpu.utils.cpp_extension`;
reference `paddle/fluid/extension/` and `framework/custom_operator.cc`'s
PD_BUILD_OP dlopen loading).

A custom op is a host C function with a flat float32 ABI

    extern "C" void op(const float** ins, const long long** shapes,
                       const int* ndims, int n_in, float* out,
                       const long long* out_shape, int out_ndim);

compiled with `g++` and bound with ctypes, or a Python / numpy callable
(`load_op_from_callable`). It enters the framework as a
`torch.autograd.Function`: its forward and backward copy their inputs to
host float32 numpy, call the C symbol or the callable, and return a
tensor on the first input's device. The computation runs on the host by
design, in both packages: the JAX package's op is a host callback
(`jax.pure_callback`), and this is that semantics on torch, not a
fallback from a device kernel (a CUDA input makes a round trip through
the host). An optional `grad_symbol` gives the gradient with the
reference's ABI: it receives `[g, *inputs]` and yields d/d input 0 only;
the other inputs get zeros.

`load` builds into the port's own directory
(`build/paddle_tpu_torch/cpp_extension`, or `build_directory=`), the
library named by the sha1 of its sources and flags, so an edited source
is rebuilt and an unchanged one is not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["load", "CppExtension", "CustomOp", "load_op_from_callable"]

_TEMPLATE_HELP = """
expected exported symbol signature (extern "C"):
  void {name}(const float** ins, const long long** shapes,
              const int* ndims, int n_in,
              float* out, const long long* out_shape, int out_ndim);
"""

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = [ctypes.POINTER(_F32P), ctypes.POINTER(_I64P),
             ctypes.POINTER(ctypes.c_int), ctypes.c_int, _F32P, _I64P,
             ctypes.c_int]


def _host(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)


class _HostOp(torch.autograd.Function):
    """The op on torch tensors: host float32 numpy in, the result on the
    first input's device out."""

    @staticmethod
    def forward(ctx, op, *tensors):
        ctx.op = op
        ctx.save_for_backward(*tensors)
        out = op._fwd(*[_host(t) for t in tensors])
        return torch.as_tensor(np.asarray(out, np.float32),
                               device=tensors[0].device)

    @staticmethod
    def backward(ctx, g):
        tensors = ctx.saved_tensors
        grads = ctx.op._bwd(_host(g), *[_host(t) for t in tensors])
        return (None,) + tuple(
            torch.as_tensor(np.asarray(d, np.float32), device=t.device)
            for d, t in zip(grads, tensors))


class CustomOp:
    """A host op: `fwd(*arrays) -> array`, `out_shape_fn(*shapes)` and an
    optional `bwd(g, *arrays) -> (d input 0, d input 1, ...)`. Calling it
    on tensors runs `_HostOp`; without `bwd` the output takes no
    gradient."""

    def __init__(self, name: str, fwd: Callable, out_shape_fn: Callable,
                 bwd: Optional[Callable] = None):
        self.name = name
        self._fwd = fwd
        self._out_shape_fn = out_shape_fn
        self._bwd = bwd

    def __call__(self, *tensors):
        if self._bwd is None:
            with torch.no_grad():
                return _HostOp.apply(self, *tensors)
        return _HostOp.apply(self, *tensors)


def load_op_from_callable(name, fwd, out_shape_fn, bwd=None):
    """Register a Python / numpy callable as a framework op (a host op)."""
    return CustomOp(name, fwd, out_shape_fn, bwd)


def _default_build_dir() -> Path:
    return (Path(__file__).resolve().parent.parent.parent / "build"
            / "paddle_tpu_torch" / "cpp_extension")


def _compile(sources: Sequence[str], extra_cxx_flags=(),
             build_directory=None) -> str:
    """`g++` the sources into one shared library, unless the library of
    these sources and flags (named by their sha1) is already built."""
    flags = ["-O2", "-fPIC", "-shared", "-std=c++17", *extra_cxx_flags]
    key = hashlib.sha1(" ".join(flags).encode())
    for s in sources:
        with open(s, "rb") as f:
            key.update(f.read())
    d = Path(build_directory) if build_directory else _default_build_dir()
    d.mkdir(parents=True, exist_ok=True)
    so = d / f"ext_{key.hexdigest()[:16]}.so"
    if not so.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([cxx, *flags[:4], "-o", str(tmp), *sources,
                            *flags[4:]], capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"custom op build failed:\n{r.stderr}\n"
                               f"{_TEMPLATE_HELP}")
        os.replace(tmp, so)
    return str(so)


def _call(sym, arrays, out_shape):
    """Call a symbol of the flat ABI on float32 `arrays`; returns the
    float32 output of `out_shape`."""
    arrays = [np.ascontiguousarray(a, np.float32) for a in arrays]
    n = len(arrays)
    ins = (_F32P * n)(*[a.ctypes.data_as(_F32P) for a in arrays])
    shape_arrs = [np.asarray(a.shape, np.longlong) for a in arrays]
    shapes = (_I64P * n)(*[s.ctypes.data_as(_I64P) for s in shape_arrs])
    ndims = (ctypes.c_int * n)(*[a.ndim for a in arrays])
    out = np.empty(tuple(out_shape), np.float32)
    oshape = np.asarray(out.shape, np.longlong)
    sym(ins, shapes, ndims, n, out.ctypes.data_as(_F32P),
        oshape.ctypes.data_as(_I64P), out.ndim)
    return out


def load(name: str, sources: Sequence[str], out_shape_fn: Callable = None,
         grad_symbol: Optional[str] = None, extra_cxx_flags=(),
         verbose=False, build_directory=None) -> CustomOp:
    """Compile and load a custom C++ op (reference
    `utils/cpp_extension.load`). `name` is the exported symbol;
    `grad_symbol`, if given, the gradient's (d/d input 0, given
    `[g, *inputs]`)."""
    lib = ctypes.CDLL(_compile(sources, extra_cxx_flags, build_directory))
    sym = getattr(lib, name)
    sym.argtypes = _ARGTYPES
    out_shape_fn = out_shape_fn or (lambda *shapes: shapes[0])

    def fwd(*arrays):
        return _call(sym, arrays,
                     out_shape_fn(*[tuple(np.shape(a)) for a in arrays]))

    bwd = None
    if grad_symbol:
        gsym = getattr(lib, grad_symbol)
        gsym.argtypes = _ARGTYPES

        def bwd(g, *arrays):  # noqa: F811
            d0 = _call(gsym, [g, *arrays], np.shape(arrays[0]))
            return (d0,) + tuple(np.zeros(np.shape(a), np.float32)
                                 for a in arrays[1:])
    return CustomOp(name, fwd, out_shape_fn, bwd)


class CppExtension:
    """setuptools-style descriptor (API parity)."""

    def __init__(self, sources, **kwargs):
        self.sources = sources
        self.kwargs = kwargs
