"""Reductions (port of `paddle_tpu.ops.reduction`; reference
`paddle/fluid/operators/reduce_ops/`).

`axis` is None (every axis), an int or a list. Types are jnp's with
64-bit types off: an integer or bool `sum` / `prod` is int32 (torch's
would be int64), `mean` of integers is float32, `count_nonzero` int32.
`median` and `quantile` interpolate linearly between the two middle
values, as jnp's do (torch's `median` takes the lower one). AMP casts by
the JAX names: `sum` is "reduce_sum" and `mean` "reduce_mean", both on
the black list, as are "logsumexp"; the others are in no list."""
from __future__ import annotations

import builtins

import torch

from ._util import acc_dtype, axis as _axis, dims, named

__all__ = ["sum", "mean", "max", "min", "prod", "all", "any", "logsumexp",
           "std", "var", "amax", "amin", "nansum", "nanmean", "count_nonzero",
           "median", "nanmedian", "quantile"]


def _keep(out, v, axis, keepdim):
    """A reduction over every axis reshaped to keep them as size 1."""
    if keepdim and axis is None:
        return out.reshape((1,) * v.dim())
    return out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    (v,) = named("reduce_sum", x)
    dt = acc_dtype(v, dtype)
    if axis is None:
        return _keep(torch.sum(v, dtype=dt), v, axis, keepdim)
    return torch.sum(v, dims(v, axis), keepdim=keepdim, dtype=dt)


def _floating(v):
    return v if v.is_floating_point() or v.is_complex() else \
        v.to(torch.float32)


def mean(x, axis=None, keepdim=False, name=None):
    (v,) = named("reduce_mean", x)
    v = _floating(v)
    if axis is None:
        return _keep(torch.mean(v), v, axis, keepdim)
    return torch.mean(v, dims(v, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    (v,) = named("reduce_max", x)
    return torch.amax(v, dims(v, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    (v,) = named("reduce_min", x)
    return torch.amin(v, dims(v, axis), keepdim=keepdim)


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    (v,) = named("reduce_prod", x)
    dt = acc_dtype(v, dtype) or v.dtype
    v = v.to(dt)
    for a in sorted((d % builtins.max(v.dim(), 1) for d in dims(v, axis)),
                    reverse=True):
        v = torch.prod(v, a, keepdim=keepdim, dtype=dt)
    return v


def all(x, axis=None, keepdim=False, name=None):
    (v,) = named("reduce_all", x)
    return torch.all(v.bool(), dims(v, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    (v,) = named("reduce_any", x)
    return torch.any(v.bool(), dims(v, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    (v,) = named("logsumexp", x)
    return torch.logsumexp(v, dims(v, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    (v,) = named("std", x)
    return torch.std(v, dims(v, axis), correction=int(unbiased),
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    (v,) = named("var", x)
    return torch.var(v, dims(v, axis), correction=int(unbiased),
                     keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    (v,) = named("nansum", x)
    dt = acc_dtype(v, dtype) or v.dtype
    if axis is None:
        return _keep(torch.nansum(v, dtype=dt), v, axis, keepdim)
    return torch.nansum(v, dims(v, axis), keepdim=keepdim, dtype=dt)


def nanmean(x, axis=None, keepdim=False, name=None):
    (v,) = named("nanmean", x)
    v = _floating(v)
    if axis is None:
        return _keep(torch.nanmean(v), v, axis, keepdim)
    return torch.nanmean(v, dims(v, axis), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    (v,) = named("count_nonzero", x)
    nz = (v != 0)
    if axis is None:
        return _keep(nz.sum(dtype=torch.int32), v, axis, keepdim)
    return nz.sum(dims(v, axis), keepdim=keepdim, dtype=torch.int32)


def _quantile(v, q, axis, keepdim, fn):
    """`fn` (torch.quantile / nanquantile) over `axis` (None: every axis,
    a tuple: those axes together), with jnp's keepdim shapes."""
    v = _floating(v)
    a = _axis(axis)
    if a is None:
        out = fn(v.reshape(-1), q, dim=0)
        if keepdim:
            out = out.reshape(out.shape + (1,) * v.dim())
        return out
    axes = sorted(d % v.dim() for d in (a if isinstance(a, tuple) else (a,)))
    rest = [d for d in range(v.dim()) if d not in axes]
    moved = v.permute(rest + axes).reshape(
        [v.shape[d] for d in rest] + [-1])
    out = fn(moved, q, dim=-1)
    if keepdim:
        shape = list(out.shape[:out.dim() - len(rest)])
        kept = [1 if d in axes else v.shape[d] for d in range(v.dim())]
        out = out.reshape(shape + kept)
    return out


def _q(q, v):
    return torch.as_tensor(q, dtype=_floating(v).dtype, device=v.device) \
        if not isinstance(q, float) else q


def median(x, axis=None, keepdim=False, name=None):
    (v,) = named("median", x)
    return _quantile(v, 0.5, axis, keepdim, torch.quantile)


def nanmedian(x, axis=None, keepdim=False, name=None):
    (v,) = named("nanmedian", x)
    return _quantile(v, 0.5, axis, keepdim, torch.nanquantile)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """A scalar `q` gives the reduced shape; a list puts its axis first."""
    (v,) = named("quantile", x)
    return _quantile(v, _q(q, v), axis, keepdim, torch.quantile)
