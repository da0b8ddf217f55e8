"""`layer_norm` (port of `paddle_tpu.nn.functional.norm.layer_norm`,
`norm.py:61-80` there; reference `python/paddle/nn/functional/norm.py`).

AMP's black op "layer_norm" and a STREAM_CAST_OUT op: under AMP its
autocast-type arguments are cast up to float32, it computes in float32
and emits the autocast type."""
from __future__ import annotations

import torch.nn.functional as TF

from ... import amp

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """(x - mean) / sqrt(var + epsilon) over the trailing
    `normalized_shape` axes (biased variance), times `weight`, plus
    `bias`. The normalisation runs in x's type; a weight or bias of
    another floating type promotes the result, as in the JAX package."""
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
