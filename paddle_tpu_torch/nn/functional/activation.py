"""Activation functionals (port of `paddle_tpu.nn.functional.activation`,
`activation.py:19-187` there; reference
`python/paddle/nn/functional/activation.py`).

Each function is the JAX package's formula in torch ops and calls AMP's
hook under its op name, as `apply_op(name, ...)` does there:
`amp.cast_args(name, ...)` on its tensor arguments, and for the
STREAM_CAST_OUT op `softmax` `amp.cast_out`. `softmax` and
`log_softmax` are black (`log_softmax` emits float32, `softmax` the
autocast type); the others are in no list and run in the type that
reaches them unless a custom list names them. `gumbel_softmax` draws its
noise from an explicit `torch.Generator` (`generator=`, or one seeded
from `framework.random.next_seed`)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...framework import random as frandom
from ...framework.static_hook import named_op

__all__ = ["relu", "relu6", "relu_", "leaky_relu", "prelu", "elu", "selu",
           "celu", "gelu", "silu", "swish", "sigmoid", "hardsigmoid",
           "hardswish", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
           "softplus", "softsign", "tanh", "mish", "maxout", "softmax",
           "log_softmax", "log_sigmoid", "glu", "gumbel_softmax",
           "thresholded_relu"]


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


@named_op
def relu(x, name=None):
    (x,) = amp.cast_args("relu", x)
    return torch.relu(x)


relu_ = relu


@named_op
def relu6(x, name=None):
    (x,) = amp.cast_args("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


@named_op
def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = amp.cast_args("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


@named_op
def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = amp.cast_args("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    ch_axis = 1 if data_format == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch_axis] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


@named_op
def elu(x, alpha=1.0, name=None):
    (x,) = amp.cast_args("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@named_op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = amp.cast_args("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@named_op
def celu(x, alpha=1.0, name=None):
    (x,) = amp.cast_args("celu", x)
    return TF.celu(x, alpha)


@named_op
def gelu(x, approximate=False, name=None):
    """x * Phi(x), exact (erf) unless `approximate` (the tanh form), as
    `jax.nn.gelu`."""
    (x,) = amp.cast_args("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@named_op
def silu(x, name=None):
    (x,) = amp.cast_args("silu", x)
    return TF.silu(x)


def swish(x, name=None):
    return silu(x)


@named_op
def sigmoid(x, name=None):
    (x,) = amp.cast_args("sigmoid", x)
    return torch.sigmoid(x)


@named_op
def log_sigmoid(x, name=None):
    (x,) = amp.cast_args("log_sigmoid", x)
    return TF.logsigmoid(x)


@named_op
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = amp.cast_args("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@named_op
def hardswish(x, name=None):
    (x,) = amp.cast_args("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@named_op
def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = amp.cast_args("hardtanh", x)
    return torch.clamp(x, min, max)


@named_op
def hardshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast_args("hardshrink", x)
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@named_op
def softshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast_args("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


@named_op
def tanhshrink(x, name=None):
    (x,) = amp.cast_args("tanhshrink", x)
    return x - torch.tanh(x)


@named_op
def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = amp.cast_args("softplus", x)
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


@named_op
def softsign(x, name=None):
    (x,) = amp.cast_args("softsign", x)
    return x / (1 + torch.abs(x))


@named_op
def tanh(x, name=None):
    (x,) = amp.cast_args("tanh", x)
    return torch.tanh(x)


@named_op
def mish(x, name=None):
    """x * tanh(softplus(x)) with `jax.nn.softplus`'s logaddexp(x, 0)."""
    (x,) = amp.cast_args("mish", x)
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


@named_op
def maxout(x, groups, axis=1, name=None):
    (x,) = amp.cast_args("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax + 1)


@named_op
def thresholded_relu(x, threshold=1.0, name=None):
    (x,) = amp.cast_args("thresholded_relu", x)
    return torch.where(x > threshold, x, _zero(x))


def _typed(x, dtype):
    return x if dtype is None else x.to(amp._torch_dtype(dtype))


@named_op
def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp.cast_args("softmax", x)
    return amp.cast_out("softmax", torch.softmax(_typed(x, dtype), axis))


@named_op
def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp.cast_args("log_softmax", x)
    return torch.log_softmax(_typed(x, dtype), axis)


@named_op
def glu(x, axis=-1, name=None):
    (x,) = amp.cast_args("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@named_op
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator=None):
    """softmax((x + g) / temperature) with g standard Gumbel noise,
    -log(-log(u)) for u uniform in [tiny, 1) as `jax.random.gumbel`
    draws it; `hard` gives the one-hot of the argmax with the soft
    gradient (straight-through)."""
    (x,) = amp.cast_args("gumbel_softmax", x)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(
            frandom.next_seed(x.device))
    tiny = torch.finfo(x.dtype).tiny
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        tiny, 1.0, generator=generator)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard + (y - y.detach())
    return y
