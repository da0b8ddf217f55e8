"""Activations: `gelu`, `softmax`, `log_softmax` (port of
`paddle_tpu.nn.functional.activation`, `activation.py:60-62, 147-162`
there; reference `python/paddle/nn/functional/activation.py`).

`gelu` is in no AMP list (it casts only when a custom list names it).
`softmax` is black and emits the autocast type (STREAM_CAST_OUT);
`log_softmax` is black and emits float32."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp

__all__ = ["gelu", "softmax", "log_softmax"]


def gelu(x, approximate=False, name=None):
    """x * Phi(x), exact (erf) unless `approximate` (the tanh form), as
    `jax.nn.gelu`."""
    (x,) = amp.cast_args("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def _typed(x, dtype):
    return x if dtype is None else x.to(amp._torch_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp.cast_args("softmax", x)
    return amp.cast_out("softmax", torch.softmax(_typed(x, dtype), axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp.cast_args("log_softmax", x)
    return torch.log_softmax(_typed(x, dtype), axis)
