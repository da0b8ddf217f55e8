"""Functional derivatives (port of `paddle_tpu.autograd.functional`;
reference `python/paddle/autograd/functional.py`): `vjp`, `jvp`,
`jacobian` and `hessian` over torch autograd.

`xs` is a tensor or a list of them; the results follow its structure
(one tensor for one input, a tuple for a list). `v` defaults to ones
like the output (vjp) or the inputs (jvp). Results are detached; the
JAX package refuses `create_graph=True` for `jacobian` and `hessian`,
and so does this. `hessian` wants `func` to return one scalar
(ValueError otherwise)."""
from __future__ import annotations

import torch

__all__ = ["vjp", "jvp", "jacobian", "hessian"]


def _inputs(xs):
    seq = isinstance(xs, (list, tuple))
    items = list(xs) if seq else [xs]
    return [torch.as_tensor(x).detach() for x in items], seq


def _detached(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(t) for t in tree)
    return tree.detach() if torch.is_tensor(tree) else tree


def _no_create_graph(create_graph, name):
    if create_graph:
        raise NotImplementedError(
            f"{name}(create_graph=True): the results are detached; nest "
            f"jacobian / hessian calls for higher orders instead")


def vjp(func, xs, v=None):
    """(func(xs), v^T d func / d xs)."""
    arrays, seq = _inputs(xs)
    with torch.enable_grad():
        ins = [a.clone().requires_grad_(True) for a in arrays]
        out = func(*ins)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        cots = [torch.ones_like(o) for o in outs] if v is None else \
            [torch.as_tensor(c) for c in (v if isinstance(v, (list, tuple))
                                          else [v])]
        got = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads = tuple(torch.zeros_like(a) if g is None else g.detach()
                  for a, g in zip(ins, got))
    return _detached(out), (grads if seq else grads[0])


def jvp(func, xs, v=None):
    """(func(xs), d func / d xs . v): forward-mode tangents."""
    arrays, seq = _inputs(xs)
    tangents = [torch.ones_like(a) for a in arrays] if v is None else \
        [torch.as_tensor(t) for t in (v if isinstance(v, (list, tuple))
                                      else [v])]
    out, tang = torch.autograd.functional.jvp(
        func, tuple(arrays), tuple(tangents))
    return _detached(out), _detached(tang)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """d func(xs) / d xs, [out shape + in shape]; an unused input gives
    zeros."""
    _no_create_graph(create_graph, "jacobian")
    arrays, seq = _inputs(xs)
    jac = torch.autograd.functional.jacobian(
        func, tuple(arrays) if seq else arrays[0])
    return _detached(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """d^2 func(xs) / d xs^2 of a scalar `func`."""
    _no_create_graph(create_graph, "hessian")
    arrays, seq = _inputs(xs)

    def scalar(*a):
        out = func(*a)
        if isinstance(out, (list, tuple)) or out.numel() != 1:
            raise ValueError(
                "hessian: func must return a single scalar (got "
                f"{type(out).__name__} of shape "
                f"{getattr(out, 'shape', None)})")
        return out.reshape(())
    hes = torch.autograd.functional.hessian(
        scalar, tuple(arrays) if seq else arrays[0])
    return _detached(hes)
