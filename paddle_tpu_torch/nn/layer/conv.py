"""Convolution layers (port of `paddle_tpu.nn.layer.conv`, `conv.py:18-152`
there; reference `python/paddle/nn/layer/conv.py`).

Each layer holds `weight` in the paddle layout, PyTorch's own ([out, in
/ groups, *k], or [in, out / groups, *k] for the transposes) and `bias`
[out] (None with `bias_attr=False`, so the state-dict names match the
JAX layer's), keeps the JAX layer's attributes (`_stride`, `_padding`,
`_dilation`, `_groups`, `_data_format`, ...) and runs its forward through
the port's functional of its name. Initialisation is the JAX package's:
weight KaimingUniform(fan_in, negative_slope=sqrt(5), "leaky_relu"),
i.e. uniform(+-1 / sqrt(fan_in)), and bias uniform(+-1 / sqrt(fan_in)),
fan_in = in / groups x prod(k); `weight_attr` / `bias_attr` initializers
replace them. `padding_mode` is taken and unused, as in the JAX
package."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import functional as F
from .. import initializer as I

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(nn.Module):
    _nd = 2
    _transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 output_padding=0, device=None, dtype=None):
        super().__init__()
        nd = self._nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        if self._transpose:
            wshape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            wshape = [out_channels, in_channels // groups, *self._kernel_size]
        self._fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(wshape, **kw))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.empty(out_channels, **kw)))
        self.reset_parameters()
        if weight_attr not in (None, False):
            weight_attr(self.weight)
        if self.bias is not None and bias_attr is not None:
            bias_attr(self.bias)

    def reset_parameters(self, generator=None):
        """Draw the weight and then the bias by the JAX layer's laws, from
        `generator` (else one seeded from `framework.random`)."""
        I.KaimingUniform(fan_in=self._fan_in, negative_slope=math.sqrt(5.0),
                         nonlinearity="leaky_relu")(self.weight, generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self._fan_in)
            I.Uniform(-bound, bound)(self.bias, generator)


class Conv1D(_ConvNd):
    _nd = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    _nd = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    _nd = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    _nd = 1
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    _nd = 2
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    _nd = 3
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  output_size, self._data_format)
