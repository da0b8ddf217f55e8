"""Shape and layout ops (port of `paddle_tpu.ops.manipulation`; reference
`python/paddle/tensor/manipulation.py`). Plain PyTorch ops on the
input's device; no TPU kernel lies here.

Each op casts by its JAX name through AMP (`_util.named`), as the JAX
package's `apply_op` does. Index arguments may be int32 (the JAX
package's type for indices); they are cast to int64 inside, where torch
requires it (`gather`, `scatter`, `take_along_axis`, ...), and no output
shows that cast. Index outputs (`nonzero`, `unique`'s) are int32, the
JAX package's type. `unique`, `nonzero` and `masked_select` have
data-dependent shapes; `unique` runs numpy's on the host, as the JAX
package does.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.dtype import canonical_dtype
from ._util import idx, ints, named, tensor

__all__ = [
    "reshape", "flatten", "transpose", "squeeze", "unsqueeze", "concat",
    "stack", "split", "chunk", "tile", "expand", "expand_as", "broadcast_to",
    "gather", "gather_nd", "scatter", "scatter_nd_add", "index_select",
    "masked_select", "where", "roll", "flip", "cast", "t", "moveaxis",
    "unbind", "repeat_interleave", "take_along_axis", "put_along_axis",
    "slice", "strided_slice", "unique", "nonzero", "pad", "rot90",
    "unstack", "crop", "shard_index", "broadcast_tensors", "atleast_1d",
    "as_real", "as_complex", "tensordot", "masked_fill", "index_put",
    "index_add", "diagonal", "one_hot", "index_fill", "diagonal_scatter",
]


def _int(a):
    return int(a.item()) if torch.is_tensor(a) else a


def reshape(x, shape, name=None):
    (v,) = named("reshape", x)
    return torch.reshape(v, ints(shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (v,) = named("flatten", x)
    nd = v.dim()
    if nd == 0:
        return v.reshape(1)
    return torch.flatten(v, start_axis % nd, stop_axis % nd)


def transpose(x, perm, name=None):
    (v,) = named("transpose", x)
    return v.permute(ints(perm))


def t(x, name=None):
    (v,) = named("t", x)
    return v if v.dim() < 2 else v.transpose(-1, -2)


def moveaxis(x, source, destination, name=None):
    (v,) = named("moveaxis", x)
    return torch.movedim(v, source, destination)


def squeeze(x, axis=None, name=None):
    """Drops the size-1 axes among `axis` (all of them when None); an
    axis of another size is kept."""
    (v,) = named("squeeze", x)
    if axis is None:
        return torch.squeeze(v)
    axes = sorted({a % v.dim() for a in ints(axis) if v.shape[a] == 1},
                  reverse=True)
    for a in axes:
        v = v.squeeze(a)
    return v


def unsqueeze(x, axis, name=None):
    (v,) = named("unsqueeze", x)
    for a in sorted(ints(axis)):
        v = v.unsqueeze(a)
    return v


def concat(x, axis=0, name=None):
    vs = named("concat", *x)
    return torch.cat(vs, dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(named("stack", *x), dim=axis)


def unbind(x, axis=0, name=None):
    (v,) = named("unbind", x)
    return list(torch.unbind(v, axis))


def unstack(x, axis=0, num=None, name=None):
    (v,) = named("unstack", x)
    return tuple(torch.unbind(v, axis))


def split(x, num_or_sections, axis=0, name=None):
    """`num_or_sections` equal parts (an int that divides the axis), or
    parts of the given sizes, one of which may be -1 (the rest)."""
    (v,) = named("split", x)
    axis = _int(axis)
    dim = v.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"split: {num_or_sections} parts do not "
                             f"divide an axis of {dim}")
        return tuple(torch.split(v, dim // num_or_sections, dim=axis))
    secs = [_int(s) for s in num_or_sections]
    known = sum(s for s in secs if s != -1)
    secs = [s if s != -1 else dim - known for s in secs]
    return tuple(torch.split(v, secs, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    (v,) = named("tile", x)
    return torch.tile(v, ints(repeat_times))


def broadcast_to(x, shape, name=None):
    (v,) = named("broadcast_to", x)
    return torch.broadcast_to(v, ints(shape))


def expand(x, shape, name=None):
    """broadcast_to where -1 keeps the input's size of that axis."""
    (v,) = named("expand", x)
    target = list(ints(shape))
    vshape = (1,) * (len(target) - v.dim()) + tuple(v.shape)
    target = [vs if s == -1 else s for s, vs in zip(target, vshape)]
    return torch.broadcast_to(v.reshape(vshape), target)


def expand_as(x, y, name=None):
    v, w = named("expand_as", x, y)
    return torch.broadcast_to(v, w.shape)


def cast(x, dtype):
    (v,) = named("cast", x)
    return v.to(canonical_dtype(dtype))


def gather(x, index, axis=0, name=None):
    v, i = named("gather", x, index)
    return torch.index_select(v, _int(axis), idx(i).reshape(-1))


def _nd(i):
    """The last axis of an index tensor as a tuple of index tensors."""
    i = idx(i)
    return tuple(i[..., j] for j in range(i.shape[-1]))


def gather_nd(x, index, name=None):
    """Entries (or slices) of `x` at the leading-axis coordinates in the
    last axis of `index`."""
    v, i = named("gather_nd", x, index)
    return v[_nd(i)]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows `index` of `x` replaced by `updates` (`overwrite`), or set to
    the sum of the updates aimed at them."""
    v, i, u = named("scatter", x, index, updates)
    i = (idx(i).reshape(-1),)
    if overwrite:
        return v.index_put(i, u)
    return v.index_put(i, torch.zeros_like(u)).index_put(i, u,
                                                         accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    v, i, u = named("scatter_nd_add", x, index, updates)
    return v.index_put(_nd(i), u, accumulate=True)


def index_select(x, index, axis=0, name=None):
    v, i = named("index_select", x, index)
    return torch.index_select(v, axis, idx(i))


def masked_select(x, mask, name=None):
    v, m = named("masked_select", x, mask)
    return torch.masked_select(v, m.bool())


def masked_fill(x, mask, value, name=None):
    v, m = named("masked_fill", x, mask)
    val = torch.as_tensor(value, dtype=v.dtype, device=v.device)
    return torch.where(m.bool(), val, v)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    c, a, b = named("where", condition, x, y)
    return torch.where(c.bool(), a, b)


def nonzero(x, as_tuple=False):
    """Coordinates of the non-zero entries: [n, ndim] int32, or a tuple of
    [n, 1] columns."""
    nz = torch.nonzero(tensor(x)).to(torch.int32)
    if as_tuple:
        return tuple(nz[:, j:j + 1] for j in range(nz.shape[1]))
    return nz


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's `unique` on the host (sorted values; the index, inverse
    and count outputs int32); results on `x`'s device."""
    v = x.detach().cpu()
    res = np.unique(v.float().numpy() if v.dtype == torch.bfloat16
                    else v.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)

    def back(r, first):
        t = torch.from_numpy(np.ascontiguousarray(r))
        t = t.to(x.dtype) if first else t.to(canonical_dtype(t.dtype))
        return t.to(x.device)
    if not isinstance(res, tuple):
        return back(res, True)
    return tuple(back(r, i == 0) for i, r in enumerate(res))


def roll(x, shifts, axis=None, name=None):
    (v,) = named("roll", x)
    if axis is None:
        return torch.roll(v, shifts)
    return torch.roll(v, shifts, axis)


def flip(x, axis, name=None):
    (v,) = named("flip", x)
    return torch.flip(v, (axis,) if isinstance(axis, int) else ints(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    (v,) = named("rot90", x)
    return torch.rot90(v, k, tuple(axes))


def repeat_interleave(x, repeats, axis=None, name=None):
    (v,) = named("repeat_interleave", x)
    r = repeats.to(v.device) if torch.is_tensor(repeats) else repeats
    return torch.repeat_interleave(v, r, dim=axis)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    v, i = named("take_along_axis", arr, indices)
    return torch.take_along_dim(v, idx(i), axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """`values` (broadcast to `indices`' shape) written along `axis` at
    `indices`: assigned, added ("add") or multiplied in ("mul")."""
    v, i = named("put_along_axis", arr, indices)
    i = idx(i)
    u = torch.broadcast_to(torch.as_tensor(values, dtype=v.dtype,
                                           device=v.device), i.shape)
    if reduce == "add":
        return torch.scatter_add(v, axis, i, u)
    if reduce == "mul":
        return torch.scatter_reduce(v, axis, i, u, "prod")
    return torch.scatter(v, axis, i, u)


def _slice_axis(v, a, s, e, st):
    if st > 0:
        sl = [builtins.slice(None)] * v.dim()
        sl[a] = builtins.slice(s, e, st)
        return v[tuple(sl)]
    # torch slices take no negative step: pick the rows Python's would
    rows = list(range(v.shape[a]))[s:e:st]
    return torch.index_select(v, a, torch.tensor(rows, dtype=torch.long,
                                                 device=v.device))


def slice(input, axes, starts, ends, name=None):
    (v,) = named("slice", input)
    for a, s, e in zip(ints(axes), ints(starts), ints(ends)):
        v = _slice_axis(v, a, s, e, 1)
    return v


def strided_slice(x, axes, starts, ends, strides, name=None):
    (v,) = named("strided_slice", x)
    for a, s, e, st in zip(*map(ints, (axes, starts, ends, strides))):
        v = _slice_axis(v, a, s, e, st)
    return v


def _pad_index(n, lo, hi, mode, device):
    """Source rows of an axis of `n` padded by (lo, hi) in numpy's
    "reflect" / "edge" / "wrap" mode."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """`pad` gives (before, after) pairs: for every axis when it has
    2 x ndim entries, else for the trailing spatial axes of
    `data_format` (NCHW-style: the last ones; NHWC-style: those after
    the batch axis). Modes: constant (`value`), reflect, replicate,
    circular."""
    (v,) = named("pad", x)
    pads = ints(pad)
    nd = v.dim()
    width = [(0, 0)] * nd
    if len(pads) == 2 * nd:
        width = [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]
    else:
        spatial = len(pads) // 2
        axes = (range(1, 1 + spatial) if data_format.endswith("C")
                else range(nd - spatial, nd))
        for j, d in enumerate(axes):
            width[d] = (pads[2 * j], pads[2 * j + 1])
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(v, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            v = torch.index_select(v, d, _pad_index(v.shape[d], lo, hi,
                                                    mode, v.device))
    return v


def crop(x, shape=None, offsets=None, name=None):
    (v,) = named("crop", x)
    shp = ints(shape)
    offs = ints(offsets) if offsets is not None else (0,) * len(shp)
    return v[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """An index's offset within shard `shard_id` of `nshards` equal
    shards of `index_num` ids, or `ignore_value` outside it (reference
    `operators/shard_index_op`)."""
    (i,) = named("shard_index", input)
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    inside = (i >= lo) & (i < lo + size)
    return torch.where(inside, i - lo, torch.full_like(i, ignore_value))


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, shape) for t in inputs]


def atleast_1d(*inputs):
    outs = [torch.atleast_1d(named("atleast_1d", x)[0]) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def as_real(x, name=None):
    (v,) = named("as_real", x)
    return torch.stack([v.real, v.imag], -1)


def as_complex(x, name=None):
    (v,) = named("as_complex", x)
    return torch.complex(v[..., 0], v[..., 1])


def tensordot(x, y, axes=2, name=None):
    a, b = named("tensordot", x, y)
    return torch.tensordot(a, b, dims=axes)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    (v,) = named("diagonal", x)
    return torch.diagonal(v, offset, axis1, axis2)


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an id outside [0, num_classes) gives a row
    of zeros (jax.nn.one_hot's rule)."""
    (v,) = named("one_hot", x)
    return (v[..., None] == torch.arange(num_classes, device=v.device)) \
        .to(torch.float32)


def index_put(x, indices, value, accumulate=False, name=None):
    v, u = named("index_put", x, value)
    return v.index_put(tuple(i if i.dtype == torch.bool else idx(i)
                             for i in indices), u, accumulate=accumulate)


def index_add(x, index, axis, value, name=None):
    v, i, u = named("index_add", x, index, value)
    return torch.index_add(v, axis, idx(i), u)


def index_fill(x, index, axis, value, name=None):
    v, i = named("index_fill", x, index)
    return torch.index_fill(v, axis, idx(i), value)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """`y` written into the `offset` diagonal of `x` over (axis1, axis2);
    `y`'s last axis runs along the diagonal."""
    v, w = named("diagonal_scatter", x, y)
    return torch.diagonal_scatter(v, w, offset, axis1, axis2)
