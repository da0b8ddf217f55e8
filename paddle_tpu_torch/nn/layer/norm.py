"""Normalisation layers (port of `paddle_tpu.nn.layer.norm`, `norm.py:21-224`
there; reference `python/paddle/nn/layer/norm.py`).

The BatchNorm family keeps the JAX package's names: parameters `weight`
(ones) and `bias` (zeros), buffers `_mean` (zeros) and `_variance`
(ones), so `load_reference_state` carries a JAX state dict by name.
They are not `torch.nn.BatchNorm2d`s, whose `running_mean`,
`running_var` and `num_batches_tracked` would break that. `momentum` is
paddle's (0.9: the weight of the running value). A layer in training
mode normalises with the batch's statistics and updates its buffers, in
eval mode it reads them (`F.batch_norm`). `weight_attr` / `bias_attr`:
False builds no parameter, an initializer fills it.

`SyncBatchNorm` behaves as BatchNorm in one process, as in the JAX
package; `convert_sync_batchnorm` swaps it in for every BatchNorm of a
model. `LayerNorm` is PyTorch's with its forward through
`F.layer_norm`."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import functional as F
from .. import initializer as I
from ..functional.norm import layer_norm

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


def _affine(module, num, weight_attr, bias_attr, device, dtype):
    """`weight` (ones) and `bias` (zeros) [num] on `module`, each None
    when its attr is False and filled by its attr when that is an
    initializer."""
    kw = dict(device=device, dtype=dtype)
    for name, attr, fill in (("weight", weight_attr, 1.0),
                             ("bias", bias_attr, 0.0)):
        p = None
        if attr is not False:
            p = nn.Parameter(torch.full((num,), fill, **kw))
            if attr is not None:
                attr(p)
        setattr(module, name, p)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine(self, num_features, weight_attr, bias_attr, device, dtype)
        kw = dict(device=device, dtype=dtype)
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm(num_channels) (reference
    `fluid/dygraph/nn.py:BatchNorm`): `act` names an `F` activation run
    on the output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device, dtype=getattr(torch, str(dtype)))
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm: in one process, BatchNorm (multi-GPU
    batch statistics wait for ROADMAP A item 19)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every BatchNorm in it (itself included) replaced
        by a SyncBatchNorm holding its parameters and buffers; returns
        the converted layer."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            w = layer._mean
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      None if layer.weight is not None else False,
                      None if layer.bias is not None else False,
                      layer._data_format, layer._use_global_stats,
                      device=w.device, dtype=w.dtype)
            out.load_state_dict(layer.state_dict())
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(nn.LayerNorm):
    """PyTorch's `LayerNorm` (its `eps`, 1e-5 by default as the JAX
    package's `epsilon`) with its forward through `F.layer_norm`, AMP's
    "layer_norm"."""

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.eps)


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _affine(self, num_channels, weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(nn.Module):
    """`weight_attr=False` builds neither weight nor bias, as in the JAX
    package."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False:
            weight_attr = bias_attr = False
        _affine(self, num_features, weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(nn.Module):
    """`weight` / sigma, sigma its largest singular value estimated by
    `power_iters` power iterations from the vectors `weight_u` [h] and
    `weight_v` [w] (h = weight_shape[dim], w the rest; normal(0, 1),
    parameters that take no gradient and are not written back, as in the
    JAX package). The gradient reaches `weight` through the iterations
    too (reference `operators/spectral_norm_op`)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        kw = dict(device=device, dtype=getattr(torch, str(dtype)))
        self.weight_u = nn.Parameter(torch.empty(h, **kw),
                                     requires_grad=False)
        self.weight_v = nn.Parameter(torch.empty(w, **kw),
                                     requires_grad=False)
        I.Normal(0.0, 1.0)(self.weight_u)
        I.Normal(0.0, 1.0)(self.weight_v)

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0)
        mat = mat.reshape(mat.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        return weight / (u @ mat @ v)
