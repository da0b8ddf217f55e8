"""Containers (port of `paddle_tpu.nn.layer.container`, `container.py:10-139`
there; reference `python/paddle/fluid/dygraph/container.py`).

Each is the `torch.nn` container with the JAX package's constructor and
the few methods torch's lacks, so children are named as there ("0",
"1", ... or the given names) and state-dict keys match:
`encoder.layers.0.self_attn.q_proj.weight`."""
from __future__ import annotations

from torch import nn

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(nn.Sequential):
    """Layers called in order. `Sequential(l0, l1, ...)` names them "0",
    "1", ...; a `(name, layer)` tuple, or one list of such tuples, names
    them. Indexing takes an int, a slice or a name."""

    def __init__(self, *layers):
        nn.Module.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self._modules[idx]
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList):
    """`torch.nn.ModuleList` built from an optional list, as
    `LayerList(sublayers)`; `append` and `extend` return the list."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    """`torch.nn.ParameterList` built from an optional list, as
    `ParameterList(parameters)`."""

    def __init__(self, parameters=None):
        super().__init__(parameters)


class LayerDict(nn.ModuleDict):
    """`torch.nn.ModuleDict` built from a mapping or (name, layer) pairs;
    `update` returns the dict."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if hasattr(sublayers, "items") \
            else sublayers
        for k, v in items:
            self[k] = v
        return self
