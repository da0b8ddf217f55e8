"""Creation ops (port of `paddle_tpu.ops.creation`; reference
`python/paddle/tensor/creation.py`).

A function that makes a tensor from nothing (`zeros`, `arange`, `eye`,
...) makes it on the default device (`set_device`; the CUDA card unless
the caller chose another, so with no card they raise UnavailableError);
`to_tensor` also takes `place=`. The `*_like` functions and those that
take a tensor work on its device. Types are the JAX package's, which
runs with 64-bit types off (`framework.dtype.canonical_dtype`): no
`dtype` gives the default float type, `arange` of ints gives int32,
`numel` an int32 scalar, float64 data float32.

`to_tensor` lives in the JAX package's `framework/tensor.py`, which has
no counterpart here (the port's tensors are `torch.Tensor`), so it is
here. `stop_gradient=False` maps to `requires_grad`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import canonical_dtype, default_float_dtype
from ..framework.place import resolve_device
from ._util import ints, named, tensor

__all__ = [
    "to_tensor", "ones", "zeros", "full", "ones_like", "zeros_like",
    "full_like", "arange", "linspace", "logspace", "eye", "empty",
    "empty_like", "meshgrid", "diag", "diagflat", "tril", "triu", "assign",
    "clone", "numel", "tril_indices", "triu_indices", "vander",
]


def _dt(dtype):
    """The type an op makes: `dtype` narrowed, or the default float."""
    return canonical_dtype(default_float_dtype() if dtype is None
                           else dtype)


def _host(data):
    """Nested data with every tensor as a numpy array."""
    if torch.is_tensor(data):
        t = data.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(data, (list, tuple)):
        return [_host(x) for x in data]
    return data


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a tensor holding `data` (a tensor, an array, a
    number or nested lists of them) in `dtype` (narrowed to 32 bits as
    the JAX package does; float64 data becomes float32 when no `dtype`
    is given) on `place` (a Place or device string; a tensor stays on its
    device when no place is given, anything else goes to the default
    device). The result is detached; `stop_gradient=False` makes it a
    leaf that requires a gradient."""
    if torch.is_tensor(data):
        t = data.detach()
        if dtype is not None:
            t = t.to(canonical_dtype(dtype))
        if place is not None:
            t = t.to(resolve_device(place))
    else:
        dev = resolve_device(place)
        a = np.asarray(_host(data))
        t = torch.from_numpy(np.ascontiguousarray(a))
        t = t.to(device=dev, dtype=canonical_dtype(
            t.dtype if dtype is None else dtype))
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def ones(shape, dtype=None, name=None):
    return torch.ones(ints(shape), dtype=_dt(dtype),
                      device=resolve_device())


def zeros(shape, dtype=None, name=None):
    return torch.zeros(ints(shape), dtype=_dt(dtype),
                       device=resolve_device())


def _fill_dtype(v):
    """jnp's type for a fill value given no dtype."""
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, (int, np.integer)):
        return torch.int32
    if isinstance(v, complex):
        return torch.complex64
    return torch.float32


def full(shape, fill_value, dtype=None, name=None):
    if torch.is_tensor(fill_value):
        fill_value = fill_value.item()
    dt = _fill_dtype(fill_value) if dtype is None else canonical_dtype(dtype)
    return torch.full(ints(shape), fill_value, dtype=dt,
                      device=resolve_device())


def _like(x, dtype):
    x = tensor(x)
    return x, (x.dtype if dtype is None else canonical_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    x, dt = _like(x, dtype)
    return torch.ones_like(x, dtype=dt)


def zeros_like(x, dtype=None, name=None):
    x, dt = _like(x, dtype)
    return torch.zeros_like(x, dtype=dt)


def full_like(x, fill_value, dtype=None, name=None):
    x, dt = _like(x, dtype)
    return torch.full_like(x, fill_value, dtype=dt)


def empty(shape, dtype=None, name=None):
    """Zeros, as the JAX package's (an XLA array is never uninitialised)."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(x):
    return x.item() if torch.is_tensor(x) else x


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is not None:
        dt = canonical_dtype(dtype)
    elif all(isinstance(v, (int, np.integer)) for v in (start, end, step)):
        dt = torch.int32
    else:
        dt = torch.float32
    return torch.arange(start, end, step, dtype=dt, device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=_dt(dtype), device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=resolve_device())


def meshgrid(*args, **kwargs):
    """Grids over 1-D inputs, "ij" indexing (the reference's)."""
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[tensor(a) for a in arrs], indexing="ij"))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D `x` on the `offset` diagonal of a square matrix whose other
    entries are `padding_value`; the `offset` diagonal of a 2-D `x`. With
    a padding value the diagonal is computed as the JAX package computes
    it, padding + x - padding (so it carries that rounding)."""
    (v,) = named("diag", x)
    if v.dim() == 1 and padding_value != 0:
        n = v.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=v.dtype,
                          device=v.device)
        return base + torch.diag(v, offset) - torch.diag(
            torch.full_like(v, padding_value), offset)
    return torch.diag(v, offset)


def diagflat(x, offset=0, name=None):
    (v,) = named("diagflat", x)
    return torch.diagflat(v, offset)


def tril(x, diagonal=0, name=None):
    (v,) = named("tril", x)
    return torch.tril(v, diagonal)


def triu(x, diagonal=0, name=None):
    (v,) = named("triu", x)
    return torch.triu(v, diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.tril_indices(row, col, offset, device=resolve_device()) \
        .to(canonical_dtype(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.triu_indices(row, col, offset, device=resolve_device()) \
        .to(canonical_dtype(dtype))


def assign(x, output=None):
    """A copy of `x` (the gradient flows through, as the reference's
    assign_op grad maker); with `output`, `x` written into it in place."""
    if output is not None:
        with torch.no_grad():
            output.copy_(tensor(x, output.device))
        return output
    if torch.is_tensor(x):
        return x.clone()
    return tensor(x)


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def vander(x, n=None, increasing=False, name=None):
    """Vandermonde matrix: column j holds x ** p_j, the powers decreasing
    unless `increasing`."""
    (v,) = named("vander", x)
    cols = v.shape[0] if n is None else int(n)
    powers = torch.arange(cols, device=v.device)
    if not increasing:
        powers = powers.flip(0)
    return v[:, None] ** powers[None, :].to(v.dtype)
