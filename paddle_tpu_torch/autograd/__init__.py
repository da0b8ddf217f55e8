"""paddle.autograd (port of `paddle_tpu.autograd`; reference
`python/paddle/autograd/`) over torch autograd, which replaces the JAX
package's tape.

- `backward`, `grad`, `no_grad`, `enable_grad`, `is_grad_enabled`:
  torch's. `grad` returns detached gradients, keeps the graph unless
  `retain_graph=False`, raises ValueError for an input the outputs do
  not reach (unless `allow_unused`), and raises NotImplementedError for
  `create_graph=True`, as the JAX package's does
  (`paddle_tpu/framework/autograd.py:200-202`).
- `PyLayer`: a custom op with static `forward(ctx, *args)` and
  `backward(ctx, *grads)`, run as a `torch.autograd.Function`.
  `ctx.save_for_backward(*tensors)` keeps tensors, and
  `ctx.saved_tensor()` (or `ctx.saved_tensor`, or `ctx.saved_tensors()`)
  gives them back; other attributes set on `ctx` live until the
  backward. `backward` returns one gradient for each tensor argument of
  `forward`, in order (None for one that needs none).
- `vjp`, `jvp`, `jacobian`, `hessian`: `autograd.functional`.
"""
from __future__ import annotations

import torch

from . import functional  # noqa: F401
from .functional import hessian, jacobian, jvp, vjp

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "PyLayer", "PyLayerContext", "PyLayerMeta", "vjp", "jvp",
           "jacobian", "hessian"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def _seq(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensor, grad_tensor=None, retain_graph=False):
    """Accumulate the gradients of `tensor` (or a list) into `.grad`."""
    tensors = _seq(tensor)
    grads = None if grad_tensor is None else _seq(grad_tensor)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """d outputs / d inputs, without touching `.grad`."""
    if create_graph:
        raise NotImplementedError(
            "grad(create_graph=True): higher-order gradients go through "
            "autograd.functional (jacobian / hessian)")
    outs, ins = _seq(outputs), _seq(inputs)
    gos = None if grad_outputs is None else [
        torch.ones_like(o) if g is None else g
        for o, g in zip(outs, _seq(grad_outputs))]
    got = torch.autograd.grad(
        outs, ins, gos, retain_graph=True if retain_graph is None
        else retain_graph, allow_unused=True)
    if not allow_unused and any(g is None for g in got):
        raise ValueError("an input Tensor is unused in the graph (pass "
                         "allow_unused=True to get None)")
    return [None if g is None else g.detach() for g in got]


class _Saved(tuple):
    """The saved tensors, readable as `ctx.saved_tensor` or
    `ctx.saved_tensor()`."""

    def __call__(self):
        return self


class PyLayerContext:
    """What `forward` and `backward` of a PyLayer share."""

    def __init__(self, fn_ctx=None):
        self._fn_ctx = fn_ctx
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        if self._fn_ctx is not None:
            self._fn_ctx.save_for_backward(*tensors)
        else:
            self._saved = tensors

    @property
    def saved_tensor(self):
        if self._fn_ctx is not None:
            return _Saved(self._fn_ctx.saved_tensors)
        return _Saved(self._saved)

    def saved_tensors(self):
        return self.saved_tensor


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    """A custom op: subclass with static `forward(ctx, *args, **kwargs)`
    and `backward(ctx, *grads)`, call `Layer.apply(*args)`."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            layer = cls

            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(fctx, kwargs, *args):
                    pctx = PyLayerContext(fctx)
                    fctx.pyctx = pctx
                    fctx.tensor_args = [torch.is_tensor(a) for a in args]
                    return layer.forward(pctx, *args, **kwargs)

                @staticmethod
                def backward(fctx, *grads):
                    got = layer.backward(fctx.pyctx, *grads)
                    got = list(got) if isinstance(got, (tuple, list)) \
                        else [got]
                    it = iter(got)
                    return (None,) + tuple(next(it, None) if is_t else None
                                           for is_t in fctx.tensor_args)
            Fn.__name__ = f"{cls.__name__}Function"
            fn = Fn
            setattr(cls, "_torch_function", fn)
        return fn

    @classmethod
    def apply(cls, *args, **kwargs):
        return cls._function().apply(kwargs, *args)
