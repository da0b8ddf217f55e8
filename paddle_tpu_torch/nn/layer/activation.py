"""Activation layers (port of `paddle_tpu.nn.layer.activation`,
`activation.py:15-64` there; reference
`python/paddle/nn/layer/activation.py`).

`GELU` subclasses `torch.nn.GELU`; the others are the JAX package's
`_simple` layers, each an `nn.Module` that keeps its constructor's
arguments and calls the functional of its name with them, and `PReLU`,
whose slope is a parameter."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .. import initializer as I
from ..functional.activation import gelu

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU",
           "GELU", "Silu", "Swish", "Sigmoid", "Hardsigmoid", "Hardswish",
           "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink", "Softplus",
           "Softsign", "Tanh", "Mish", "Maxout", "Softmax", "LogSoftmax",
           "LogSigmoid", "ThresholdedReLU", "GLU"]


class GELU(nn.GELU):
    """Exact (erf) GELU unless `approximate` (True or "tanh")."""

    def __init__(self, approximate=False, name=None):
        super().__init__("tanh" if approximate in (True, "tanh") else "none")

    def forward(self, x):
        return gelu(x, approximate=self.approximate == "tanh")


def _simple(name, fn_name):
    def __init__(self, *args, **kwargs):
        nn.Module.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, fn_name)(x, *self._args, **self._kwargs)

    return type(name, (nn.Module,), {
        "__init__": __init__, "forward": forward,
        "__doc__": f"`F.{fn_name}` as a layer; its arguments are the "
                   f"constructor's."})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
ELU = _simple("ELU", "elu")
SELU = _simple("SELU", "selu")
CELU = _simple("CELU", "celu")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Sigmoid = _simple("Sigmoid", "sigmoid")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Hardtanh = _simple("Hardtanh", "hardtanh")
Hardshrink = _simple("Hardshrink", "hardshrink")
Softshrink = _simple("Softshrink", "softshrink")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Softplus = _simple("Softplus", "softplus")
Softsign = _simple("Softsign", "softsign")
Tanh = _simple("Tanh", "tanh")
Mish = _simple("Mish", "mish")
Maxout = _simple("Maxout", "maxout")
Softmax = _simple("Softmax", "softmax")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
GLU = _simple("GLU", "glu")


class PReLU(nn.Module):
    """max(0, x) + weight * min(0, x) with `weight` [num_parameters] a
    parameter (one slope, or one a channel of `data_format`), filled with
    `init` unless `weight_attr` is an initializer."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        self._data_format = data_format
        self.weight = nn.Parameter(torch.empty(num_parameters,
                                               device=device, dtype=dtype))
        attr = weight_attr if weight_attr not in (None, False) \
            else I.Constant(init)
        attr(self.weight)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
