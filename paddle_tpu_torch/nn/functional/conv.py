"""Convolutions (port of `paddle_tpu.nn.functional.conv`, `conv.py:16-164`
there; reference `python/paddle/nn/functional/conv.py`).

The JAX package runs one `lax.conv_general_dilated` per op; here each op
is one `torch.nn.functional.conv{1,2,3}d` (cuDNN on the card). Weights
keep the paddle layout, which is PyTorch's too: [out, in / groups, *k],
and [in, out / groups, *k] for the transposes, so nothing is transposed.

Every op is AMP's white op of its name ("conv2d", "conv2d_transpose",
...): under `amp.auto_cast` its float32 arguments are cast to the
autocast type, as `apply_op` does there.

Padding takes the JAX package's forms (`_padding`): an int, one int a
spatial dim, 2 x nd ints (lo, hi a dim), a list of (lo, hi) pairs, or
"SAME" / "VALID". "SAME" is lax's: ceil(in / stride) outputs, the pad
split with the smaller half first, so at stride 2 it is asymmetric.
torch's convolutions take only symmetric padding, so where the two sides
of a dim differ the input is padded explicitly first (`TF.pad`, zeros).
The channel-last layouts (NLC / NWC, NHWC, NDHWC) are permuted to
channels-first and back; the weight stays in the paddle layout."""
from __future__ import annotations

import torch.nn.functional as TF

from ... import amp
from ...framework.static_hook import named_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def explicit_pads(padding, n, sizes, windows, strides):
    """[(lo, hi)] for each of the n spatial dims, from any of the JAX
    package's padding forms; "SAME" / "VALID" against the input `sizes`,
    the (dilated) `windows` and the `strides`, as `lax.padtype_to_pads`
    computes them."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for size, win, s in zip(sizes, windows, strides):
            total = max((-(-size // s) - 1) * s + win - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    pads = [tuple(p) for p in padding]
    if len(pads) != n:
        raise ValueError(f"padding {padding!r} does not give {n} spatial "
                         f"(lo, hi) pairs")
    return pads


def flat_pads(pads):
    """(lo, hi) pairs for the leading spatial dims first, as `TF.pad`'s
    flat list (last dim first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _cast(op, x, weight, bias):
    if bias is None:
        x, weight = amp.cast_args(op, x, weight)
    else:
        x, weight, bias = amp.cast_args(op, x, weight, bias)
    return x, weight, bias


def _conv(nd, x, weight, bias, stride, padding, dilation, groups,
          data_format):
    channel_last = data_format in CHANNEL_LAST
    stride, dilation = ntuple(stride, nd), ntuple(dilation, nd)
    x, weight, bias = _cast(f"conv{nd}d", x, weight, bias)
    if channel_last:
        x = x.movedim(-1, 1)
    windows = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = explicit_pads(padding, nd, x.shape[2:], windows, stride)
    if all(lo == hi >= 0 for lo, hi in pads):
        out = _CONV[nd](x, weight, bias, stride, [lo for lo, _ in pads],
                        dilation, groups)
    else:
        out = _CONV[nd](TF.pad(x, flat_pads(pads)), weight, bias, stride, 0,
                        dilation, groups)
    return out.movedim(1, -1) if channel_last else out


@named_op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(1, x, weight, bias, stride, padding, dilation, groups,
                 "NWC" if data_format in ("NLC", "NWC") else "NCW")


@named_op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(2, x, weight, bias, stride, padding, dilation, groups,
                 data_format)


@named_op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(3, x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def _conv_transpose(nd, x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format):
    """torch's transposed convolution with no padding (the full output),
    then cropped by (lo, hi - output_padding) a dim, zeros where
    output_padding reaches past it: the JAX package's lhs-dilated
    convolution padded by (K - lo, K - hi + output_padding), K the
    dilated kernel's extent - 1, whatever the pads' symmetry. The bias
    is added after the crop, so the positions output_padding adds hold
    it too."""
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for conv_transpose")
    channel_last = data_format in CHANNEL_LAST
    stride, dilation = ntuple(stride, nd), ntuple(dilation, nd)
    opad = ntuple(output_padding, nd)
    pads = explicit_pads(padding, nd, None, None, None)
    x, weight, bias = _cast(f"conv{nd}d_transpose", x, weight, bias)
    if channel_last:
        x = x.movedim(-1, 1)
    full = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    out = TF.pad(full, flat_pads([(-lo, op - hi)
                                  for (lo, hi), op in zip(pads, opad)]))
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return out.movedim(1, -1) if channel_last else out


@named_op
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """`output_size` is taken and unused, as in the JAX package."""
    return _conv_transpose(
        1, x, weight, bias, stride, padding, output_padding, dilation,
        groups, "NWC" if data_format in ("NLC", "NWC") else "NCW")


@named_op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """`output_size` is taken and unused, as in the JAX package."""
    return _conv_transpose(2, x, weight, bias, stride, padding,
                           output_padding, dilation, groups, data_format)


@named_op
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """`output_size` is taken and unused, as in the JAX package."""
    return _conv_transpose(3, x, weight, bias, stride, padding,
                           output_padding, dilation, groups, data_format)
