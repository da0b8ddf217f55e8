"""`Linear`, `Embedding`, `Dropout` (port of `paddle_tpu.nn.layer.common`;
reference `python/paddle/nn/layer/common.py`).

Each subclasses its `torch.nn` counterpart, keeps its constructor, its
parameter names and PyTorch's [out, in] Linear layout, and runs its
forward through the port's functional op, so AMP sees the op's name."""
from __future__ import annotations

from torch import nn

from ..functional import common as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Linear):
    """y = x W^T + b, W [out_features, in_features] as in PyTorch; the
    forward hands `F.linear` the JAX package's [in, out] view of it."""

    def forward(self, x):
        return F.linear(x, self.weight.t(), self.bias)


class Embedding(nn.Embedding):
    """Rows of the weight at integer ids; `padding_idx` rows are zero at
    construction (PyTorch's rule, the JAX package's too) and give zeros
    and no gradient in the forward (`F.embedding`)."""

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Dropout(nn.Dropout):
    """`F.dropout` as a module, with the JAX package's `axis` and `mode`
    beside PyTorch's `p`."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)
