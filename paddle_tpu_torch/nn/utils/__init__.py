"""`nn.utils` (port of `paddle_tpu.nn.utils`; reference `python/paddle/nn/
utils/`): `weight_norm` / `remove_weight_norm`, `spectral_norm`,
`parameters_to_vector` / `vector_to_parameters`.

The reparametrizations keep the reference's names: `{name}_g` and
`{name}_v` (weight norm), `{name}_orig` and the sublayer
`{name}_spectral_norm` with its `weight_u` / `weight_v` (spectral norm),
and recompute `{name}` in a forward pre-hook. A port `Linear` holds its
weight as the transpose of the reference's ([out, in]); its `{name}_g`,
`{name}_v` and `{name}_orig` are the transposes of the reference's too,
`dim` counts in the reference's layout, and `models.
load_reference_state` transposes them as it transposes the weight.
`parameters_to_vector` concatenates the parameters as they are stored,
so a port `Linear` weight enters it transposed.

Weight norm's gradient reaches v through ||v|| too, as in the JAX
package's functional path (`Model.fit`) and upstream Paddle; the JAX
package's eager tape drops that term (ROADMAP C24)."""
from __future__ import annotations

import torch

from ..layer.norm import SpectralNorm

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _ref_view(layer, w):
    """`w` in the reference's layout: a port Linear's weight transposed."""
    return w.t() if isinstance(layer, torch.nn.Linear) else w


def _norm_except(w, dim):
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparametrize `name` as g * v / ||v|| (the norm over every axis
    but `dim`): parameters `{name}_g` and `{name}_v` replace it, and a
    forward pre-hook recomputes it."""
    dim = 0 if dim is None else dim
    w = getattr(layer, name)
    with torch.no_grad():
        g = _ref_view(layer, _norm_except(_ref_view(layer, w), dim))
    delattr(layer, name)
    layer.register_parameter(f"{name}_g", torch.nn.Parameter(g.clone()))
    layer.register_parameter(f"{name}_v",
                             torch.nn.Parameter(w.detach().clone()))

    def hook(mod, inputs):
        v = _ref_view(mod, getattr(mod, f"{name}_v"))
        g = _ref_view(mod, getattr(mod, f"{name}_g"))
        setattr(mod, name, _ref_view(mod, v * (g / _norm_except(v, dim))))

    layer._weight_norm_handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_name = name
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g and v back into one parameter `name`."""
    handle = getattr(layer, "_weight_norm_handle", None)
    if handle is not None:
        handle.remove()
    w = getattr(layer, name).detach().clone()
    for pn in (f"{name}_g", f"{name}_v"):
        layer._parameters.pop(pn, None)
    delattr(layer, name)
    layer.register_parameter(name, torch.nn.Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """Reparametrize `name` as {name}_orig / sigma through the sublayer
    `{name}_spectral_norm` (`nn.SpectralNorm` over the reference's
    layout), recomputed in a forward pre-hook."""
    w = getattr(layer, name)
    ref_shape = tuple(_ref_view(layer, w).shape)
    sn = SpectralNorm(ref_shape, dim=dim, power_iters=n_power_iterations,
                      eps=eps, dtype=str(w.dtype).replace("torch.", ""),
                      device=w.device)
    layer.add_module(f"{name}_spectral_norm", sn)
    orig = layer._parameters.pop(name)
    layer.register_parameter(f"{name}_orig", orig)

    def hook(mod, inputs):
        o = getattr(mod, f"{name}_orig")
        setattr(mod, name, _ref_view(mod, sn(_ref_view(mod, o))))

    layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None):
    """One 1-D tensor of every parameter, flattened as stored, in order."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of `vec` into each parameter (no
    gradient is recorded)."""
    off = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
            off += n
