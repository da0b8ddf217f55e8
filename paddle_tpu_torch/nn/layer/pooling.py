"""Pooling layers (port of `paddle_tpu.nn.layer.pooling`, `pooling.py:13-85`
there; reference `python/paddle/nn/layer/pooling.py`).

Each keeps its constructor's arguments and calls the functional of its
name with them: `_Pool(kernel_size, stride, padding, **kwargs)` and
`_AdaptivePool(output_size, **kwargs)` (`name` dropped)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, **self.kwargs)


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"


class MaxPool1D(_Pool):
    _fn = "max_pool1d"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class _AdaptivePool(nn.Module):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, self._fn)(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = "adaptive_avg_pool2d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"
