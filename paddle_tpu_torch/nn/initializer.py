"""Initializers (port of `paddle_tpu.nn.initializer`, `initializer.py:22-153`
there; reference `python/paddle/fluid/initializer.py`).

The JAX package's initializers build a new array from a shape. PyTorch's
parameters exist before they are filled, so here each initializer fills
a tensor in place and returns it:

    I.Normal(0.0, 0.02)(layer.weight, generator=g)

Every random draw comes from an explicit `torch.Generator` on the
tensor's device: the one passed, or else a fresh one seeded from
`framework.random.next_seed(device)`, so `framework.random.seed`
reproduces it. Fans follow the JAX package's layout: a 2-D shape is
[in, out] (its Linear weight), so a port `Linear` hands its [out, in]
weight over transposed (`weight.t()`, a view filled in place)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as frandom

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "calculate_gain"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        f = shape[0] if shape else 1
        return f, f
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # paddle fc weights are [in, out]; conv are [out, in, k, k]
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    else:
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4}
    return gains.get(nonlinearity, 1.0)


def _generator(tensor, generator):
    if generator is not None:
        return generator
    return torch.Generator(device=tensor.device).manual_seed(
        frandom.next_seed(tensor.device))


class Initializer:
    """Fills `tensor` in place (no autograd) and returns it. A tensor on
    the "meta" device holds no values: nothing is drawn."""

    def __call__(self, tensor, generator=None):
        if tensor.is_meta:
            return tensor
        with torch.no_grad():
            self._fill(tensor, generator)
        return tensor

    def _fill(self, tensor, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, tensor, generator):
        tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, tensor, generator):
        tensor.normal_(self.mean, self.std,
                       generator=_generator(tensor, generator))


class TruncatedNormal(Initializer):
    """mean + std * a standard normal cut to [-2, 2] (the JAX package's
    `jax.random.truncated_normal(key, -2, 2)`)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, tensor, generator):
        g = _generator(tensor, generator)
        z = torch.empty(tensor.shape, dtype=torch.float32,
                        device=tensor.device)
        # inverse CDF of the standard normal over (Phi(-2), Phi(2))
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
            (1 + math.erf(2 / math.sqrt(2))) / 2
        z.uniform_(lo, hi, generator=g)
        z = torch.special.ndtri(z).clamp_(-2.0, 2.0)
        tensor.copy_(self.mean + self.std * z)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, tensor, generator):
        tensor.uniform_(self.low, self.high,
                        generator=_generator(tensor, generator))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, generator):
        fi, fo = _fans(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        tensor.uniform_(-limit, limit,
                        generator=_generator(tensor, generator))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, generator):
        fi, fo = _fans(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        tensor.normal_(0.0, std, generator=_generator(tensor, generator))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, tensor, generator):
        fi, _ = _fans(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        tensor.uniform_(-limit, limit,
                        generator=_generator(tensor, generator))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, tensor, generator):
        fi, _ = _fans(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        tensor.normal_(0.0, std, generator=_generator(tensor, generator))


class Assign(Initializer):
    """The given values (an array, a tensor or a nested list), which must
    have the tensor's shape; no draw."""

    def __init__(self, value):
        self.value = value

    def _fill(self, tensor, generator):
        v = self.value
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
        if tuple(v.shape) != tuple(tensor.shape):
            raise ValueError(f"Assign init shape {tuple(v.shape)} != "
                             f"{tuple(tensor.shape)}")
        tensor.copy_(v.to(tensor.dtype))
