"""`LayerNorm` (port of `paddle_tpu.nn.layer.norm.LayerNorm`; reference
`python/paddle/nn/layer/norm.py`)."""
from __future__ import annotations

from torch import nn

from ..functional.norm import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.LayerNorm):
    """PyTorch's `LayerNorm` (its `eps`, 1e-5 by default as the JAX
    package's `epsilon`) with its forward through `F.layer_norm`, AMP's
    "layer_norm"."""

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.eps)
