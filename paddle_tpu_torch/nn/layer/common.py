"""`Linear`, `Embedding`, `Dropout` (port of `paddle_tpu.nn.layer.common`;
reference `python/paddle/nn/layer/common.py`).

Each subclasses its `torch.nn` counterpart, keeps its constructor, its
parameter names and PyTorch's [out, in] Linear layout, and runs its
forward through the port's functional op, so AMP sees the op's name.
`Linear` and `Embedding` also take the JAX package's `weight_attr=` /
`bias_attr=` as keywords: an `nn.initializer` fills the parameter at
construction (drawing as that module says), and `bias_attr=False` builds
no bias."""
from __future__ import annotations

from torch import nn

from ..functional import common as F

__all__ = ["Linear", "Embedding", "Dropout"]


def _apply_attr(attr, tensor):
    """Fill `tensor` with `attr` when it is an initializer; None (the
    layer's default) and False leave it as it is."""
    if attr is not None and attr is not False:
        attr(tensor)


class Linear(nn.Linear):
    """y = x W^T + b, W [out_features, in_features] as in PyTorch; the
    forward hands `F.linear` the JAX package's [in, out] view of it.
    `weight_attr` fills that [in, out] view, so fans read as the JAX
    package's."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None, *, weight_attr=None, bias_attr=None, name=None):
        super().__init__(in_features, out_features,
                         bias=bias and bias_attr is not False,
                         device=device, dtype=dtype)
        _apply_attr(weight_attr, self.weight.t())
        if self.bias is not None:
            _apply_attr(bias_attr, self.bias)

    def forward(self, x):
        return F.linear(x, self.weight.t(), self.bias)


class Embedding(nn.Embedding):
    """Rows of the weight at integer ids; `padding_idx` rows are zero at
    construction (PyTorch's rule, the JAX package's too, after
    `weight_attr`) and give zeros and no gradient in the forward
    (`F.embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 *args, weight_attr=None, name=None, **kwargs):
        super().__init__(num_embeddings, embedding_dim, padding_idx, *args,
                         **kwargs)
        if weight_attr is not None:
            _apply_attr(weight_attr, self.weight)
            self._fill_padding_idx_with_zero()

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
