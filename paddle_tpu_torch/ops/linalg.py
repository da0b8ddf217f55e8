"""Linear algebra ops (port of `paddle_tpu.ops.linalg`, `linalg.py:18-33,
164` there; reference `python/paddle/tensor/linalg.py`): `matmul`,
`mm`, `bmm` and `einsum`, the white-listed products of AMP.

Each casts its arguments through `amp.cast_args` under its op name, as
the JAX package's `apply_op` does, then promotes mixed floating types to
their common type as `jnp.matmul` does (a bfloat16 and a float32
operand give a float32 product; torch's own products refuse mixed
types). The products go to torch's GEMMs, as the JAX package leaves them
to XLA."""
from __future__ import annotations

import functools

import torch

from .. import amp

__all__ = ["matmul", "mm", "bmm", "einsum", "promoted"]


def promoted(*tensors):
    """`tensors` with every floating tensor cast to their common
    floating type (jnp's promotion: bfloat16 with float16 gives float32);
    other arguments as they are."""
    types = {t.dtype for t in tensors
             if torch.is_tensor(t) and t.is_floating_point()}
    if len(types) <= 1:
        return tensors
    dt = functools.reduce(torch.promote_types, types)
    return tuple(t.to(dt) if torch.is_tensor(t) and t.is_floating_point()
                 else t for t in tensors)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, each transposed over its last two axes first when asked
    (a 1-D operand is never transposed)."""
    a, b = promoted(*amp.cast_args("matmul", x, y))
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(input, mat2, name=None):
    return torch.matmul(*promoted(*amp.cast_args("mm", input, mat2)))


def bmm(x, y, name=None):
    return torch.matmul(*promoted(*amp.cast_args("bmm", x, y)))


def einsum(equation, *operands):
    return torch.einsum(equation,
                        *promoted(*amp.cast_args("einsum", *operands)))
