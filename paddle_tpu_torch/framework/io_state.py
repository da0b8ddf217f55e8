"""paddle.save / paddle.load (port of `paddle_tpu.framework.io_state`;
reference `fluid/dygraph/checkpoint.py:56,128` save_dygraph /
load_dygraph).

The format is the JAX package's: a pickled object (protocol 4 by
default) whose tensors became numpy arrays, written to `.pdparams` /
`.pdopt`. So each package's `load` opens what the other's `save` wrote.
numpy has no bfloat16, so a bfloat16 tensor is saved as float32 (exact);
`set_state_dict` casts it back to the parameter's type. `load` returns
numpy, as the JAX package's does; `set_state_dict(module, state)` puts a
loaded state dict into a `torch.nn.Module` on the module's own device
(the port's layers are torch modules, which have no
`Layer.set_state_dict`; the JAX package's `bfloat16` arrays are read
too).

Names and layouts stay each package's own: the port's Linear weights are
[out, in], the JAX package's [in, out]. Weights cross packages through
`models.load_reference_state`, which transposes the Linears.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load", "set_state_dict", "to_tensor_state"]


def _to_saveable(obj):
    if torch.is_tensor(obj):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path: str, **configs):
    with open(path, "rb") as f:
        return pickle.load(f)


def _tensor(a, device, dtype=None):
    """A numpy array (or number, or tensor) as a tensor on `device`, in
    `dtype` when given."""
    if isinstance(a, np.ndarray) and a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    return t.to(device=device, dtype=dtype or t.dtype)


def to_tensor_state(state, device):
    """A loaded state (nested dicts / lists of arrays) with every array a
    tensor on `device`."""
    if isinstance(state, dict):
        return {k: to_tensor_state(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(to_tensor_state(v, device) for v in state)
    if isinstance(state, np.ndarray) or torch.is_tensor(state):
        return _tensor(state, device)
    return state


def set_state_dict(module: torch.nn.Module, state, strict=True):
    """Load `state` ({name: array or tensor}, as `load` gives) into
    `module`: each entry becomes a tensor of its parameter's or buffer's
    type on its device. With `strict`, a missing or unexpected key
    raises (torch's `load_state_dict` rule). Returns torch's
    (missing, unexpected) keys."""
    own = module.state_dict()
    tensors = {k: _tensor(v, own[k].device, own[k].dtype) if k in own
               else v for k, v in state.items()}
    return module.load_state_dict(tensors, strict=strict)
