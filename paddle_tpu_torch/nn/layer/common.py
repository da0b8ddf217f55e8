"""Common layers (port of `paddle_tpu.nn.layer.common`; reference
`python/paddle/nn/layer/common.py`).

`Linear`, `Embedding` and `Dropout` each subclass their `torch.nn`
counterpart, keeps its constructor, its
parameter names and PyTorch's [out, in] Linear layout, and runs its
forward through the port's functional op, so AMP sees the op's name.
`Linear` and `Embedding` also take the JAX package's `weight_attr=` /
`bias_attr=` as keywords: an `nn.initializer` fills the parameter at
construction (drawing as that module says), and `bias_attr=False` builds
no bias. The others are `nn.Layer`s over the functionals of
`nn.functional.common`; `Bilinear` keeps the reference's weight
[out, in1, in2] (torch's layout too), made by `Layer.create_parameter`."""
from __future__ import annotations

from torch import nn

from ...framework import static_hook
from ...framework.static_hook import named_op
from ...ops.manipulation import flatten
from ..functional import common as F
from .layers import Layer

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Embedding", "Flatten", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "Bilinear",
           "CosineSimilarity", "PairwiseDistance", "Identity", "PixelShuffle",
           "Unfold"]


def _apply_attr(attr, tensor):
    """Fill `tensor` with `attr` when it is an initializer; None (the
    layer's default) and False leave it as it is."""
    if attr is not None and attr is not False:
        attr(tensor)


@named_op
def _linear_out_in(x, weight, bias=None, weight_layout="out_in"):
    """`F.linear` over a [out, in] weight: one op "linear" of a static
    Program whose inputs are the layer's own parameters (the transposed
    view is taken inside it); `weight_layout` tells the Program's passes
    the weight's layout."""
    return F.linear(x, weight.t(), bias)


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
        with static_hook.suppressed():   # never ops of a static Program
            _apply_attr(weight_attr, self.weight.t())
            if self.bias is not None:
                _apply_attr(bias_attr, self.bias)

    def forward(self, x):
        return _linear_out_in(x, self.weight, self.bias,
                              weight_layout="out_in")


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


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    """`F.interpolate` as a layer (the JAX package's resize, C20)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class _PadNd(Layer):
    _df = "NCL"

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format or self._df

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    _df = "NCL"


class Pad2D(_PadNd):
    _df = "NCHW"


class Pad3D(_PadNd):
    _df = "NCDHW"


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)
