"""Normalisation functionals (port of `paddle_tpu.nn.functional.norm`,
`norm.py:14-151` there; reference `python/paddle/nn/functional/norm.py`,
`operators/{batch,layer,group,instance}_norm_op.*`).

`batch_norm`, `layer_norm`, `group_norm` and `instance_norm` are AMP
black ops: under `amp.auto_cast` their autocast-type arguments are cast
up to float32 and they compute in float32. Only `layer_norm` is a
STREAM_CAST_OUT op and emits the autocast type; the others emit
float32, so under O1 a BatchNorm between two convolutions hands the next
one float32, which that white op casts back."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...framework.static_hook import named_op

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm"]

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


@named_op
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """(x - mean) / sqrt(var + epsilon) * weight + bias a channel, with
    the batch's statistics (biased variance) in training unless
    `use_global_stats`, else the running ones. In training the running
    buffers are updated in place, as the reference kernel's side effect:
    running = momentum * running + (1 - momentum) * batch, the variance
    unbiased (n / (n - 1)); note the paddle sense of `momentum`, the
    weight of the old value (torch's is 1 - it).

    The update reads the input as it reached this op, before AMP's cast
    (the JAX package reads `x._value`): under O1 the batch mean and
    variance entering the buffers are rounded to the autocast type, and
    so is each (1 - momentum) * statistic product, while the
    normalisation uses the float32 statistics. The batch variance comes
    back from the kernel's 1 / sqrt(var + epsilon), so it carries the
    float32 rounding of that round trip (relative 2^-22 x (1 + epsilon /
    var)) on top."""
    channel_last = data_format in _CHANNEL_LAST
    use_batch = training and not use_global_stats
    src_dtype = x.dtype
    x, rm, rv, weight, bias = amp.cast_args(
        "batch_norm", x, running_mean, running_var, weight, bias)
    if channel_last:
        x = x.movedim(-1, 1)
    if not use_batch:
        out = TF.batch_norm(x, rm, rv, weight, bias, False, 0.0, epsilon)
    else:
        out, mean, invstd = torch.native_batch_norm(
            x, weight, bias, None, None, True, 0.0, epsilon)
        if running_mean is not None:
            _update_running(running_mean, running_var, mean, invstd,
                            x.numel() // x.shape[1], src_dtype, momentum,
                            epsilon)
    return out.movedim(1, -1) if channel_last else out


@torch.no_grad()
def _update_running(running_mean, running_var, mean, invstd, n, dtype,
                    momentum, epsilon):
    m = mean.to(dtype)
    var = (invstd.pow(-2) - epsilon).clamp_(min=0.0).to(dtype)
    var = var * (n / max(n - 1, 1))
    running_mean.mul_(momentum).add_(m * (1 - momentum))
    running_var.mul_(momentum).add_(var * (1 - momentum))


@named_op
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """(x - mean) / sqrt(var + epsilon) over the trailing
    `normalized_shape` axes (biased variance), times `weight`, plus
    `bias`. The normalisation runs in x's type; a weight or bias of
    another floating type promotes the result, as in the JAX package.
    A STREAM_CAST_OUT op: under AMP it emits the autocast type."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = list(normalized_shape)
    x, weight, bias = amp.cast_args("layer_norm", x, weight, bias)
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        out = TF.layer_norm(x, shape, weight, bias, epsilon)
    else:
        out = TF.layer_norm(x, shape, None, None, epsilon)
        if weight is not None:
            out = out * weight
        if bias is not None:
            out = out + bias
    return amp.cast_out("layer_norm", out)


@named_op
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial positions
    (biased variance), times `weight`, plus `bias` a channel. The running
    statistics, `use_input_stats` and `momentum` are taken and unused, as
    in the JAX package."""
    channel_last = data_format in _CHANNEL_LAST
    x, weight, bias = amp.cast_args("instance_norm", x, weight, bias)
    if channel_last:
        x = x.movedim(-1, 1)
    out = TF.instance_norm(x, None, None, weight, bias, True, 0.0, eps)
    return out.movedim(1, -1) if channel_last else out


@named_op
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Each sample's channels split into `num_groups` groups, each
    normalised over its channels and positions (biased variance), times
    `weight`, plus `bias` a channel."""
    channel_last = data_format in _CHANNEL_LAST
    x, weight, bias = amp.cast_args("group_norm", x, weight, bias)
    if channel_last:
        x = x.movedim(-1, 1)
    out = TF.group_norm(x, num_groups, weight, bias, epsilon)
    return out.movedim(1, -1) if channel_last else out


@named_op
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * s)^beta, s the sum of squares over the `size`
    channels around each one (size // 2 before it, the rest after, zeros
    past the ends). The JAX package scales the SUM by alpha (upstream
    Paddle and torch scale the mean), so torch's op runs with alpha x
    size."""
    (x,) = amp.cast_args("local_response_norm", x)
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = x.movedim(-1, 1)
    out = TF.local_response_norm(x, size, alpha * size, beta, k)
    return out.movedim(1, -1) if channel_last else out
