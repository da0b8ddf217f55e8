"""Comparison, logical and bitwise ops (port of `paddle_tpu.ops.logic`;
reference `paddle/fluid/operators/controlflow/compare_op.cc`,
`logical_op.cc`). `equal_all`, `allclose` and `is_empty` give a 0-d bool
tensor on the input's device, as the JAX package's give a 0-d array."""
from __future__ import annotations

import torch

from ._util import named, tensor

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "equal_all", "allclose", "isclose", "is_empty",
           "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "is_tensor"]


def _binary(opname, fn, tensors=False):
    def op(x, y, name=None):
        a, b = named(opname, x, y)
        if tensors and not torch.is_tensor(b):
            b = torch.as_tensor(b, device=a.device)
        return fn(a, b)
    op.__name__ = op.__qualname__ = opname
    return op


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
logical_and = _binary("logical_and", torch.logical_and, True)
logical_or = _binary("logical_or", torch.logical_or, True)
logical_xor = _binary("logical_xor", torch.logical_xor, True)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    (v,) = named("logical_not", x)
    return torch.logical_not(v)


def bitwise_not(x, name=None):
    (v,) = named("bitwise_not", x)
    return torch.bitwise_not(v)


def _flag(value, like):
    return torch.tensor(bool(value), device=like.device)


def equal_all(x, y, name=None):
    """True when `x` and `y` have one shape and equal entries."""
    a, b = named("equal_all", x, y)
    same = tuple(a.shape) == tuple(b.shape) and bool(torch.equal(
        *_promoted(a, b)))
    return _flag(same, a)


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = named("allclose", x, y)
    return _flag(torch.allclose(*_promoted(a, b), rtol=rtol, atol=atol,
                                equal_nan=equal_nan), a)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = named("isclose", x, y)
    return torch.isclose(*_promoted(a, b), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def is_empty(x, name=None):
    x = tensor(x)
    return _flag(x.numel() == 0, x)


def is_tensor(x):
    return torch.is_tensor(x)
