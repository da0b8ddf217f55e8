"""Pooling (port of `paddle_tpu.nn.functional.pooling`, `pooling.py:35-159`
there; reference `python/paddle/nn/functional/pooling.py`).

The JAX package pools with `lax.reduce_window`; here each op is torch's
pooling of its rank. What the port keeps of the JAX package, where it
differs from upstream Paddle (ROADMAP C14):
- `ceil_mode` and `return_mask` are taken and ignored: output sizes are
  always floor'd, and a max pool returns its values only;
- `exclusive=True` divides an average by the count of in-bounds cells
  (torch's `count_include_pad=False`), except under a string padding,
  where it divides by the window size;
- `adaptive_max_pool*` has no channel-last form.

Padding takes the convolutions' forms (`conv.explicit_pads`; "SAME" with
the window undilated). torch pools only where each dim's pad is
symmetric and at most half the window; any other pad is applied first,
with -inf for a max and zeros for an average, as `reduce_window` pads.
Adaptive bins run from floor(i n / o) to ceil((i + 1) n / o), torch's
bins and the JAX package's alike.

Each op calls `amp.cast_args` under the JAX op's name
("max_pool2d", "adaptive_avg_pool2d", ...), which is in neither list, so
under AMP it runs in the type that reaches it."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from .conv import explicit_pads, flat_pads, ntuple
from ...framework.static_hook import named_op

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _pool(nd, x, kernel, stride, padding, kind, exclusive, channel_last):
    kernel = ntuple(kernel, nd)
    stride = ntuple(stride if stride is not None else kernel, nd)
    (x,) = amp.cast_args(f"{kind}_pool{nd}d", x)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = explicit_pads(padding, nd, x.shape[2:], kernel, stride)
    direct = all(lo == hi and 0 <= lo <= k // 2
                 for (lo, hi), k in zip(pads, kernel))
    sym = [lo for lo, _ in pads] if direct else 0
    if kind == "max":
        if not direct:
            x = TF.pad(x, flat_pads(pads), value=float("-inf"))
        out = _MAX[nd](x, kernel, stride, sym)
    else:
        by_window = not exclusive or isinstance(padding, str)
        if direct:
            out = _AVG[nd](x, kernel, stride, sym,
                           count_include_pad=by_window)
        else:
            out = _AVG[nd](TF.pad(x, flat_pads(pads)), kernel, stride)
            if not by_window:
                ones = torch.ones((1, 1) + tuple(x.shape[2:]),
                                  dtype=x.dtype, device=x.device)
                out = out / _AVG[nd](TF.pad(ones, flat_pads(pads)), kernel,
                                     stride)
    return out.movedim(1, -1) if channel_last else out


@named_op
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(1, x, kernel_size, stride, padding, "max", True,
                 data_format == "NLC")


@named_op
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(2, x, kernel_size, stride, padding, "max", True,
                 data_format == "NHWC")


@named_op
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(3, x, kernel_size, stride, padding, "max", True,
                 data_format == "NDHWC")


@named_op
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(1, x, kernel_size, stride, padding, "avg", exclusive,
                 data_format == "NLC")


@named_op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """`divisor_override` is taken and unused, as in the JAX package."""
    return _pool(2, x, kernel_size, stride, padding, "avg", exclusive,
                 data_format == "NHWC")


@named_op
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """`divisor_override` is taken and unused, as in the JAX package."""
    return _pool(3, x, kernel_size, stride, padding, "avg", exclusive,
                 data_format == "NDHWC")


def _adaptive(nd, x, output_size, kind, channel_last):
    (x,) = amp.cast_args(f"adaptive_{kind}_pool{nd}d", x)
    if channel_last:
        x = x.movedim(-1, 1)
    out = _ADAPTIVE[kind, nd](x, ntuple(output_size, nd))
    return out.movedim(1, -1) if channel_last else out


@named_op
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(1, x, output_size, "avg", False)


@named_op
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(2, x, output_size, "avg", data_format == "NHWC")


@named_op
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(3, x, output_size, "avg", data_format == "NDHWC")


@named_op
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(1, x, output_size, "max", False)


@named_op
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(2, x, output_size, "max", False)


@named_op
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(3, x, output_size, "max", False)
