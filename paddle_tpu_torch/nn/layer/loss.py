"""Loss layers (port of `paddle_tpu.nn.layer.loss`; reference
`python/paddle/nn/layer/loss.py`): each a layer over its functional of
`nn.functional.loss`, with the JAX package's defaults."""
from __future__ import annotations

from torch import nn

from ..functional import loss as F
from ..functional.loss import cross_entropy
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "KLDivLoss",
           "SmoothL1Loss", "BCELoss", "BCEWithLogitsLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "CTCLoss"]


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


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class CTCLoss(Layer):
    """`F.ctc_loss` as a layer (input lengths unread, C21)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction)
