"""The reference's Tensor methods, as a table (port of
`paddle_tpu.ops.tensor_methods`; reference
`python/paddle/fluid/dygraph/math_op_patch.py`).

The JAX package patches its op functions and operator overloads onto its
own `Tensor` class. The port's tensors are `torch.Tensor`, which it
neither wraps nor patches, so this module says, for each of the
reference's method names, what serves it on a `torch.Tensor`:

- `TORCH`: torch's own method of that name takes the same arguments and
  means the same (`x.exp()`, `x.reshape(shape)`, `x + y`, ...);
- a function of the port: torch's method means something else or does
  not exist, so call the function with the tensor first
  (`manipulation.transpose(x, perm)` for `x.transpose(perm)`,
  `reduction.sum(x, axis=1)` for `x.sum(axis=1)`, `reduction.max(x, 1)`,
  which gives values only, `manipulation.split(x, 2, axis=1)`, ...).

Every method name the JAX package patches has one of the two; none is
left without.

`call(x, name, *args, **kwargs)` runs the entry for `name` on `x`. The
in-place entries (`reshape_`, `scatter_`, ...) that torch lacks write
their result into the tensor's storage (`Tensor.set_`), outside
autograd, as the JAX package's adopt the new value.
"""
from __future__ import annotations

import torch

from . import linalg, logic, manipulation, math, reduction, search

__all__ = ["TORCH", "METHODS", "call", "inplace"]

TORCH = "torch"


def inplace(fn):
    """An in-place method of `fn`: its result replaces `x`'s storage,
    shape and type; returns `x`."""
    def method(x, *args, **kwargs):
        with torch.no_grad():
            out = fn(x, *args, **kwargs)
            x.set_(out.detach().clone().contiguous())
        return x
    method.__name__ = getattr(fn, "__name__", "inplace") + "_"
    return method


_SAME = [
    # math: torch's method computes the same function of the same args
    "exp", "log", "sqrt", "rsqrt", "square", "abs", "sign", "floor", "ceil",
    "round", "trunc", "sin", "cos", "tan", "tanh", "sigmoid", "erf",
    "reciprocal", "clip", "isnan", "isinf", "isfinite", "add", "subtract",
    "multiply", "divide", "pow", "maximum", "minimum", "floor_divide",
    "remainder", "neg", "lerp", "addmm",
    # manipulation
    "reshape", "flatten", "tile", "expand", "expand_as", "broadcast_to",
    "masked_select", "roll", "unbind", "repeat_interleave", "diagonal",
    "masked_fill", "moveaxis",
    # linalg
    "matmul", "mm", "bmm", "dist", "inverse", "det", "matrix_power", "mv",
    # logic
    "not_equal", "less_equal", "greater_equal", "logical_and",
    "logical_or", "logical_xor", "logical_not", "isclose", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not",
    # creation
    "tril", "triu",
    # in place
    "clip_", "tanh_", "exp_", "sqrt_", "rsqrt_", "reciprocal_", "round_",
    "floor_", "ceil_", "abs_", "subtract_", "add_", "multiply_", "zero_",
    "fill_",
    # operators
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__floordiv__", "__rfloordiv__",
    "__mod__", "__pow__", "__rpow__", "__matmul__", "__rmatmul__",
    "__neg__", "__abs__", "__invert__", "__and__", "__or__", "__xor__",
    "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__",
    "__getitem__", "__setitem__", "__iter__",
]

METHODS = {n: TORCH for n in _SAME}
METHODS.update({
    # torch: scale is absent; cumsum / cumprod need a dim (None flattens
    # here); trace takes no offset / axes; mod is absent
    "scale": math.scale, "cumsum": math.cumsum, "cumprod": math.cumprod,
    "trace": math.trace, "mod": math.mod,
    # torch: sum / mean / prod / std / var / logsumexp / all / any take
    # `dim`, not `axis` (and int types widen to int64); max / min with a
    # dim return (values, indices)
    "sum": reduction.sum, "mean": reduction.mean, "max": reduction.max,
    "min": reduction.min, "prod": reduction.prod, "all": reduction.all,
    "any": reduction.any, "logsumexp": reduction.logsumexp,
    "std": reduction.std, "var": reduction.var,
    # torch: transpose swaps two dims; squeeze / unsqueeze take one dim;
    # split takes section sizes; chunk allows uneven parts; gather /
    # scatter index elementwise; index_select takes (dim, index); flip
    # wants a list; t is 2-D only; cast / astype / take_along_axis /
    # put_along_axis / gather_nd are absent; unique / nonzero give
    # other outputs (int64, no inverse / index of the reference's)
    "transpose": manipulation.transpose, "squeeze": manipulation.squeeze,
    "unsqueeze": manipulation.unsqueeze, "split": manipulation.split,
    "chunk": manipulation.chunk, "gather": manipulation.gather,
    "gather_nd": manipulation.gather_nd, "scatter": manipulation.scatter,
    "index_select": manipulation.index_select, "flip": manipulation.flip,
    "cast": manipulation.cast, "astype": manipulation.cast,
    "take_along_axis": manipulation.take_along_axis,
    "put_along_axis": manipulation.put_along_axis,
    "unique": manipulation.unique, "nonzero": manipulation.nonzero,
    "t": manipulation.t,
    # torch: dot is 1-D only; norm / cross take other defaults;
    # cholesky is deprecated for torch.linalg's
    "dot": linalg.dot, "norm": linalg.norm, "cross": linalg.cross,
    "cholesky": linalg.cholesky,
    # torch: equal gives one bool; less_than / greater_than / equal_all
    # are absent; allclose gives a Python bool
    "equal": logic.equal, "less_than": logic.less_than,
    "greater_than": logic.greater_than, "allclose": logic.allclose,
    "equal_all": logic.equal_all,
    # torch: the arg / sort ops give int64 indices (int32 here) or named
    # tuples, and sort's stability is opt-in
    "argmax": search.argmax, "argmin": search.argmin,
    "argsort": search.argsort, "sort": search.sort, "topk": search.topk,
    "kthvalue": search.kthvalue,
    # in place: torch has none of these, or one that means other things
    "reshape_": inplace(manipulation.reshape),
    "squeeze_": inplace(manipulation.squeeze),
    "unsqueeze_": inplace(manipulation.unsqueeze),
    "flatten_": inplace(manipulation.flatten),
    "scatter_": inplace(manipulation.scatter),
    "scale_": inplace(math.scale),
})


def call(x, name, *args, **kwargs):
    """Run the reference's method `name` on tensor `x`."""
    entry = METHODS[name]
    if entry is TORCH:
        return getattr(x, name)(*args, **kwargs)
    return entry(x, *args, **kwargs)
