"""`nn.Layer`, the base of user layers (port of `paddle_tpu.nn.layer.
layers.Layer`, `layers.py:36-308` there; reference `python/paddle/fluid/
dygraph/layers.py`).

`Layer` is a `torch.nn.Module`, so a network written as `class Net(nn.
Layer)` is a torch module: torch's `parameters()`, `state_dict()`,
`to()`, `train()` and `__call__` stay as they are (`hapi.Model`, `jit`,
`io_state` and the optimizers rely on them). Beside them it has the
reference's own methods: `create_parameter` (on the thread's default
device, the CUDA card unless `set_device` chose another), `add_parameter`,
`add_sublayer`, `register_buffer(..., persistable=)`, `sublayers`,
`named_sublayers`, `full_name`, `astype`, `set_state_dict`,
`register_forward_post_hook` and `clear_gradients`; `to()` also takes the
reference's keywords (`device=` a place string or Place, `dtype=` a
framework type name, `blocking=`)."""
from __future__ import annotations

import torch

from ...framework import io_state
from ...framework.dtype import to_torch_dtype
from ...framework.param_attr import ParamAttr
from ...framework.place import Place, resolve_device
from .. import initializer as I

__all__ = ["Layer"]


def _torch_device(device):
    """A place string ("gpu", "gpu:1", "cpu", "cuda:0"), a Place or a
    torch device, as the checked torch device it names."""
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        if name.lower() == "gpu":
            device = f"cuda:{idx or 0}"
    return resolve_device(device)


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or type(self).__name__.lower()

    # -- construction -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter of `shape` in the reference's layout, filled by
        the attr's initializer, else `default_initializer`, else
        Constant(0) for a bias and XavierUniform for a weight; carries
        the attr's `trainable`, `need_clip`, learning rate and
        regularizer. `attr=False` gives None."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        value = torch.empty([int(s) for s in shape],
                            dtype=to_torch_dtype(dtype or self._dtype),
                            device=resolve_device(None))
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierUniform())
        init(value)
        p = torch.nn.Parameter(value, requires_grad=bool(attr.trainable))
        p.need_clip = bool(attr.need_clip)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """torch's `register_buffer`; `persistable` is the reference's
        name for torch's `persistent` (a non-persistable buffer stays out
        of `state_dict`)."""
        if tensor is not None and not torch.is_tensor(tensor):
            tensor = torch.as_tensor(tensor)
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    # -- traversal ----------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) of every sublayer, depth first, each once."""
        memo = layers_set if layers_set is not None else set()
        for name, m in self.named_modules(memo=memo, prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def full_name(self):
        return self._full_name

    # -- type / device --------------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """torch's `Module.to`, also taking the reference's place strings
        ("gpu:0", a Place) and framework type names; `blocking=False` is
        torch's `non_blocking=True`."""
        args = [_to_arg(a) for a in args]
        if device is not None:
            kwargs["device"] = _torch_device(device)
        if dtype is not None:
            kwargs["dtype"] = to_torch_dtype(dtype)
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- state --------------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load {name: array or tensor} by name: each becomes a tensor of
        its parameter's or buffer's type on its device; a shape mismatch
        raises. Returns (missing, unexpected) names, as the reference."""
        res = io_state.set_state_dict(self, state_dict, strict=False)
        return list(res.missing_keys), list(res.unexpected_keys)

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- hooks --------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) after each forward; a non-None
        result replaces the outputs. Returns a handle with `remove()`."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


def _to_arg(a):
    """A positional argument of `Layer.to` in torch's terms."""
    if isinstance(a, (torch.device, torch.Tensor, torch.dtype)):
        return a
    if isinstance(a, Place):
        return a.torch_device()
    try:
        return to_torch_dtype(a)
    except (TypeError, KeyError, ValueError):
        return _torch_device(a) if isinstance(a, str) else a
