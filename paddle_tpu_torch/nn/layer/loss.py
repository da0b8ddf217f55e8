"""Loss layers (port of `paddle_tpu.nn.layer.loss`; reference
`python/paddle/nn/layer/loss.py`)."""
from __future__ import annotations

from torch import nn

from ..functional.loss import cross_entropy

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """`cross_entropy` as a module. `reduction` is a plain attribute that
    callers may change between calls (hapi's masked losses set it to
    "none" to read per-position values)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return cross_entropy(input, label, self.weight, self.ignore_index,
                             self.reduction, self.soft_label, self.axis,
                             self.use_softmax)
