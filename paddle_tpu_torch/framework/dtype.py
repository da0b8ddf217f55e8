"""Dtypes (port of `paddle_tpu.framework.dtype`; reference
`paddle/fluid/framework/data_type.h`, `framework.proto` VarType.Type).

The framework's dtype names (`float32` ... `complex128`, `bool_`) are
`DType`s that name a `torch.dtype`. `convert_dtype` takes any spelling
(a name, a numpy type, a torch type, a `DType`) to a `DType`;
`to_torch_dtype` gives its `torch.dtype`.

The JAX package runs with 64-bit types off, so every type an op of its
creates in 64 bits comes out in 32: `arange(5)` and `argmax` (whose
`dtype` defaults to "int64") give int32, float64 data gives float32.
The port's ops make the same types: `canonical_dtype` narrows a
requested type as jnp does (int64 -> int32, float64 -> float32,
complex128 -> complex64), and the ops that take a `dtype=`
argument go through it. A `DType` itself still names its exact torch
type (`paddle.int64` is torch.int64), for code that hands it to torch.

The default float type (`set_default_dtype`, `get_default_dtype`; the
reference has them in `ops/legacy.py`) is what the creation and random
ops make when given no `dtype`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "convert_dtype", "to_torch_dtype", "canonical_dtype",
    "default_float_dtype", "set_default_dtype", "get_default_dtype",
    "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
    "to_paddle_dtype_name", "is_floating_point_dtype", "is_integer_dtype",
]


class DType:
    """A framework dtype: a name and the `torch.dtype` it stands for.
    Equal to its name, to its torch type and to its numpy type."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return self.torch_dtype == to_torch_dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.name)


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = [bool_, uint8, int8, int16, int32, int64, float16, bfloat16,
        float32, float64, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME["bool_"] = bool_
_BY_TORCH = {d.torch_dtype: d for d in _ALL}
_NARROW = {"int64": int32, "float64": float32, "complex128": complex64}

_default_float = float32


def convert_dtype(dtype) -> DType:
    """Any dtype spelling (str, numpy type, torch type, DType) to a
    DType; None gives the default float type."""
    if dtype is None:
        return _default_float
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype in _BY_TORCH:
            return _BY_TORCH[dtype]
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    if isinstance(dtype, str) and dtype in _BY_NAME:
        return _BY_NAME[dtype]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise TypeError(f"Unsupported dtype: {dtype!r}") from None
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise TypeError(f"Unsupported dtype: {dtype!r}")


def to_torch_dtype(dtype) -> torch.dtype:
    return convert_dtype(dtype).torch_dtype


def to_paddle_dtype_name(dtype) -> str:
    return convert_dtype(dtype).name


def is_floating_point_dtype(dtype) -> bool:
    return to_torch_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    t = to_torch_dtype(dtype)
    return not (t.is_floating_point or t.is_complex or t == torch.bool)


def canonical_dtype(dtype) -> torch.dtype:
    """The torch type an op of the port makes for `dtype`: the JAX
    package's type with 64-bit types off (64-bit types narrowed to 32)."""
    d = convert_dtype(dtype)
    return _NARROW.get(d.name, d).torch_dtype


def default_float_dtype() -> DType:
    return _default_float


def set_default_dtype(d) -> None:
    """paddle.set_default_dtype: only floating types are legal
    (reference `python/paddle/framework/framework.py`)."""
    dt = convert_dtype(d)
    if not dt.torch_dtype.is_floating_point:
        raise TypeError(
            f"set_default_dtype only supports float dtypes, got {dt}")
    global _default_float
    _default_float = dt


def get_default_dtype() -> str:
    return _default_float.name
