"""What the vision models share: the device their layers are built on
and the seeded draw of their weights."""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ...framework.place import resolve_device
from ...nn import initializer as I
from ...nn.layer.conv import _ConvNd


@contextlib.contextmanager
def building_on(device):
    """Every layer constructed inside lands on `device`: the CUDA card
    unless the caller passes another; raises where there is none
    (`framework.place.resolve_device`)."""
    with torch.device(resolve_device(device)):
        yield


@torch.no_grad()
def init_weights(model, seed):
    """Draw every parameter of `model` from one generator seeded with
    `seed`, in module order, by the JAX package's laws: each convolution's
    weight and bias (`reset_parameters`), each Linear's weight
    Xavier-uniform over its [in, out] fans and its bias zero. BatchNorms
    keep their ones and zeros. `seed` None keeps the layers' own draws
    (from `framework.random`)."""
    if seed is None:
        return
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(
        int(seed))
    for m in model.modules():
        if isinstance(m, _ConvNd):
            m.reset_parameters(g)
        elif isinstance(m, nn.Linear):
            I.XavierUniform()(m.weight.t(), generator=g)
            if m.bias is not None:
                m.bias.zero_()
