"""ParamAttr (port of `paddle_tpu.framework.param_attr`; reference
`python/paddle/fluid/param_attr.py`): a parameter's name, initializer,
learning-rate scale, regularizer and trainability, as one argument.

The port's layers that take `weight_attr` / `bias_attr` call the attr on
the new parameter, so a `ParamAttr` is callable: it fills the tensor
with its initializer (when it has one), turns the parameter's gradient
off with `trainable=False`, and sets the parameter's `need_clip`, which
the `nn.ClipGrad*` classes read, as the JAX package stores it on its
`Parameter`. A bare `nn.initializer` instance
works there too, and `False` drops a bias where the layer allows it."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    def __call__(self, tensor):
        if self.initializer is not None:
            self.initializer(tensor)
        # a layer may hand over a view of its parameter (Linear's
        # [in, out] transpose)
        base = tensor if tensor._base is None else tensor._base
        if not self.trainable:
            base.requires_grad_(False)
        base.need_clip = bool(self.need_clip)
        return tensor

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        # an Initializer instance
        return ParamAttr(initializer=attr)
