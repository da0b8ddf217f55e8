"""Search and sort ops (port of `paddle_tpu.ops.search`; reference
`python/paddle/tensor/search.py`, `operators/arg_max_op`,
`top_k_v2_op`, `argsort_op`). Index outputs are int32, the JAX
package's type for the reference's int64 with 64-bit types off (an
explicit `dtype=` is narrowed the same way). Sorts are stable. `mode`
runs numpy on the host, as the JAX package's does: the most frequent
value of a row (the smallest on a tie) and the index of its last
occurrence."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import canonical_dtype
from ._util import idx, named

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "searchsorted",
           "kthvalue", "mode", "index_sample", "bucketize"]

_I32 = torch.int32


def _arg(fn, opname, x, axis, keepdim, dtype):
    (v,) = named(opname, x)
    dt = canonical_dtype(dtype)
    if axis is None:
        out = fn(v.reshape(-1), 0)
        if keepdim:
            out = out.reshape((1,) * v.dim())
        return out.to(dt)
    return fn(v, axis, keepdim=keepdim).to(dt)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, "argmax", x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, "argmin", x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    (v,) = named("argsort", x)
    return torch.argsort(v, dim=axis, descending=descending,
                         stable=True).to(_I32)


def sort(x, axis=-1, descending=False, name=None):
    (v,) = named("sort", x)
    return torch.sort(v, dim=axis, descending=descending, stable=True).values


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if torch.is_tensor(k):
        k = int(k.item())
    (v,) = named("top_k_v2", x)
    vals, ids = torch.topk(v, k, dim=axis, largest=largest, sorted=True)
    return vals, ids.to(_I32)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s, v = named("searchsorted", sorted_sequence, values)
    return torch.searchsorted(s, v, right=right).to(_I32)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """Bucket indices of `x` in a 1-D sorted sequence (searchsorted)."""
    return searchsorted(sorted_sequence, x, out_int32=out_int32,
                        right=right, name=name)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest value along `axis` and its index (1-based k)."""
    (v,) = named("kthvalue", x)
    vals, ids = torch.kthvalue(v, k, dim=axis, keepdim=keepdim)
    return vals, ids.to(_I32)


def mode(x, axis=-1, keepdim=False, name=None):
    v = x.detach().cpu()
    vm = np.moveaxis(v.float().numpy() if v.dtype == torch.bfloat16
                     else v.numpy(), axis, -1)
    rows = vm.reshape(-1, vm.shape[-1])
    vals, inds = [], []
    for r in rows:
        u, counts = np.unique(r, return_counts=True)
        m = u[np.argmax(counts)]
        vals.append(m)
        inds.append(np.where(r == m)[0][-1])
    shape = vm.shape[:-1]
    mv = torch.from_numpy(np.array(vals).reshape(shape)).to(x.dtype)
    mi = torch.from_numpy(np.array(inds).reshape(shape)).to(_I32)
    if keepdim:
        mv, mi = mv.unsqueeze(axis), mi.unsqueeze(axis)
    return mv.to(x.device), mi.to(x.device)


def index_sample(x, index):
    """Per-row gather: out[i, j] = x[i, index[i, j]]."""
    v, i = named("index_sample", x, index)
    return torch.gather(v, 1, idx(i))
