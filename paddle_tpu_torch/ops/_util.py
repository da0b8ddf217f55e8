"""Helpers shared by the port's dense ops (creation, manipulation, logic,
reduction, search, random_ops, linalg): argument normalisation, the
JAX package's output types, and a walker over nests of tensors."""
from __future__ import annotations

import numpy as np
import torch

from .. import amp
from ..framework.dtype import canonical_dtype
from ..framework.place import resolve_device

# jnp's result type for an integer reduction (sum, prod) with 64-bit
# types off: every signed integer and bool sums in int32
_INT_ACC = {torch.bool, torch.int8, torch.int16, torch.int32, torch.uint8}


def tensor(x, device=None):
    """`x` as a tensor: a tensor as it is; a Python number or array in
    the JAX package's types (float64 -> float32, int64 -> int32) on
    `device` (default: the default device)."""
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=resolve_device(device),
                dtype=canonical_dtype(t.dtype))


def ints(v):
    """A shape or list of ints from ints, tensors or lists of either."""
    if torch.is_tensor(v):
        return tuple(int(x) for x in v.reshape(-1).tolist())
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(x.item() if torch.is_tensor(x) else x) for x in v)


def axis(a):
    """An `axis` argument as None, an int or a tuple of ints."""
    if torch.is_tensor(a):
        a = a.tolist()
    if isinstance(a, (list, tuple)):
        return tuple(int(x) for x in a)
    return a


def dims(x, a):
    """`axis` as torch's `dim`: a tuple of every axis for None."""
    a = axis(a)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def named(op_name, *args):
    """AMP's cast by op name (the JAX package's `apply_op(op_name, ...)`):
    a tuple of `args`: a Python number stays one (torch's scalars are
    weakly typed, as jnp's are), an array becomes a tensor on the first
    tensor's device."""
    dev = next((a.device for a in args if torch.is_tensor(a)), None)
    return amp.cast_args(op_name, *[
        a if torch.is_tensor(a) or isinstance(a, (bool, int, float, complex))
        else tensor(a, dev) for a in args])


def acc_dtype(x, dtype=None):
    """The type of jnp's sum / prod of `x`: `dtype` narrowed when given,
    int32 for a signed integer or bool `x`, else None (x's own)."""
    if dtype is not None:
        return canonical_dtype(dtype)
    return torch.int32 if x.dtype in _INT_ACC else None


def idx(i):
    """An index tensor as torch's gather / scatter want it (int64). The
    cast is internal: outputs keep the JAX package's types."""
    return i.long() if torch.is_tensor(i) else torch.as_tensor(i).long()


def nest_map(fn, tree):
    """`fn` on every leaf of a nest of tuples, lists and dicts, in
    jax.tree_util's order (a dict's keys sorted), in the same nest."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(nest_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: nest_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def nest_leaves(tree):
    """The leaves of a nest, in `nest_map`'s order."""
    out = []
    nest_map(out.append, tree)
    return out
