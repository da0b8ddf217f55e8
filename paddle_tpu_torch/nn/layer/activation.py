"""`GELU` (port of `paddle_tpu.nn.layer.activation.GELU`; reference
`python/paddle/nn/layer/activation.py`)."""
from __future__ import annotations

from torch import nn

from ..functional.activation import gelu

__all__ = ["GELU"]


class GELU(nn.GELU):
    """Exact (erf) GELU unless `approximate` (True or "tanh")."""

    def __init__(self, approximate=False, name=None):
        super().__init__("tanh" if approximate in (True, "tanh") else "none")

    def forward(self, x):
        return gelu(x, approximate=self.approximate == "tanh")
