"""Gradient clipping and `nn.utils`: paddle_tpu_torch held to paddle_tpu.

- R3: `ParamAttr(need_clip=False)` reaches the parameter, and each clip
  class's `__call__` passes such a pair through and leaves it out of the
  global norm, as the reference's do (`paddle_tpu/nn/clip.py:32, 50, 74,
  83`); an optimizer's own clip (`_clip_grads`) clips every gradient, as
  the reference's `_tree_clip` does. A two-Linear model with one such
  weight, the same gradients in both packages: each class's pairs, and a
  clipped optimizer step, agree.
- `clip_by_global_norm_pytree` over a nest.
- `weight_norm` / `remove_weight_norm` / `spectral_norm` on a Linear
  (whose port weight is the reference's transposed) and a Conv2D, their
  parameters carried by `load_reference_state`: outputs and the
  gradients of g and v against the JAX package's functional path (its
  eager tape drops the gradient through ||v||, ROADMAP C24);
  `parameters_to_vector` / `vector_to_parameters`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import load_reference_state
from torch_ops_parity import (compare, jax_jit_grads,  # noqa: F401
                              on_the_cpu, r)

TOL = 1e-5


def _two_linear(P):
    return P.nn.Sequential(
        P.nn.Linear(4, 5, weight_attr=P.ParamAttr(need_clip=False)),
        P.nn.Linear(5, 3))


def _models():
    paddle.seed(6)
    ref = _two_linear(paddle)
    port = _two_linear(ptt)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state(port, state)
    return ref, port


def _grads(port):
    """A gradient for every parameter in the JAX package's layout, large
    enough that every clip acts."""
    return {n: r(10 + i, *tuple(p.shape)[::-1] if p.dim() == 2
                 else tuple(p.shape)) * 3.0
            for i, (n, p) in enumerate(port.named_parameters())}


def _t(a, p):
    return torch.from_numpy(a.T.copy() if p.dim() == 2 else a)


@pytest.mark.parametrize("clip", ["ClipGradByGlobalNorm", "ClipGradByNorm",
                                  "ClipGradByValue"])
def test_clip_classes_skip_need_clip_false_as_jax(clip):
    ref, port = _models()
    assert port[0].weight.need_clip is False
    assert getattr(port[1].weight, "need_clip", True) is True
    grads = _grads(port)
    jpairs = [(p, paddle.to_tensor(grads[n]))
              for n, p in ref.named_parameters()]
    tpairs = [(p, _t(grads[n], p)) for n, p in port.named_parameters()]
    arg = 0.1 if clip != "ClipGradByValue" else 0.5
    want = getattr(paddle.nn, clip)(arg)(jpairs)
    got = getattr(ptt.nn, clip)(arg)(tpairs)
    for (tp, tg), (_, jg) in zip(got, want):
        compare(clip, tg.t() if tp.dim() == 2 else tg, jg, TOL)
    # the need_clip=False pair passes through untouched
    assert got[0][1] is tpairs[0][1]
    # against clipping every gradient: the result differs
    every = getattr(ptt.nn, clip)(arg)._clip_grads([g for _, g in tpairs])
    assert not torch.allclose(every[0], got[0][1])


def test_optimizer_clip_ignores_need_clip_as_jax():
    ref, port = _models()
    x = r(20, 6, 4)
    jopt = paddle.optimizer.SGD(0.5, parameters=ref.parameters(),
                                grad_clip=paddle.nn.ClipGradByGlobalNorm(0.1))
    topt = ptt.optimizer.SGD(0.5, parameters=port.named_parameters(),
                             grad_clip=ptt.nn.ClipGradByGlobalNorm(0.1))
    (ref(paddle.to_tensor(x)) ** 2).sum().backward()
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    jopt.step()
    topt.step()
    jstate = {k: v for k, v in ref.state_dict().items()}
    for n, p in port.named_parameters():
        compare(n, p.detach().t() if p.dim() == 2 else p.detach(),
                jstate[n], TOL)


def test_clip_by_global_norm_pytree_matches_jax():
    tree = {"b": [r(30, 3), r(31, 2, 2)], "a": (r(32, 4),)}
    want = paddle.nn.clip.clip_by_global_norm_pytree(
        {"b": [a for a in tree["b"]], "a": tuple(tree["a"])}, 0.5)
    got = ptt.nn.clip.clip_by_global_norm_pytree(
        {"b": [torch.from_numpy(a) for a in tree["b"]],
         "a": (torch.from_numpy(tree["a"][0]),)}, 0.5)
    assert isinstance(got["a"], tuple) and isinstance(got["b"], list)
    for g, w in zip(got["b"] + list(got["a"]), want["b"] + list(want["a"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def _layers(kind):
    if kind == "linear":
        return (paddle.nn.Linear(4, 5), ptt.nn.Linear(4, 5), r(40, 3, 4))
    return (paddle.nn.Conv2D(2, 3, 3), ptt.nn.Conv2D(2, 3, 3),
            r(41, 2, 2, 6, 6))


@pytest.mark.parametrize("kind,dim", [("linear", 0), ("linear", 1),
                                      ("conv", 0)])
def test_weight_norm_matches_jax(kind, dim):
    paddle.seed(7)
    jl, tl, x = _layers(kind)
    jl = paddle.nn.utils.weight_norm(jl, dim=dim)
    tl = ptt.nn.utils.weight_norm(tl, dim=dim)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert {"weight_g", "weight_v"} <= set(state) and "weight" not in state
    assert sorted(state) == sorted(tl.state_dict())
    load_reference_state(tl, state)
    jout, _, jgrads = jax_jit_grads(jl, [x], [], layer=jl)
    tout = tl(torch.from_numpy(x))
    compare("weight_norm", tout, jout, TOL)
    w = np.random.RandomState(5).standard_normal(
        tuple(tout.shape)).astype(np.float32)
    (tout * torch.from_numpy(w)).sum().backward()
    for n in ("weight_g", "weight_v"):
        g = getattr(tl, n).grad
        compare(n, g.t() if kind == "linear" else g, jgrads[n], TOL)
    ptt.nn.utils.remove_weight_norm(tl)
    assert "weight" in dict(tl.named_parameters())
    assert "weight_g" not in tl.state_dict()
    compare("removed", tl(torch.from_numpy(x)), jout, TOL)


def test_spectral_norm_matches_jax():
    paddle.seed(8)
    jl, tl, x = _layers("linear")
    jl = paddle.nn.utils.spectral_norm(jl, n_power_iterations=2)
    tl = ptt.nn.utils.spectral_norm(tl, n_power_iterations=2)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(tl.state_dict())
    load_reference_state(tl, state)
    assert tuple(tl.weight_spectral_norm.weight_u.shape) == (4,)
    compare("spectral_norm", tl(torch.from_numpy(x)),
            jl(paddle.to_tensor(x)), TOL)


def test_parameters_to_vector_round_trip():
    paddle.seed(9)
    jc, tc = paddle.nn.GRUCell(3, 4), ptt.nn.GRUCell(3, 4)
    load_reference_state(tc, {k: np.asarray(v.numpy())
                              for k, v in jc.state_dict().items()})
    want = paddle.nn.utils.parameters_to_vector(jc.parameters())
    got = ptt.nn.utils.parameters_to_vector(tc.parameters())
    compare("parameters_to_vector", got.detach(), want, 0)
    ptt.nn.utils.vector_to_parameters(got.detach() * 2, tc.parameters())
    compare("vector_to_parameters", tc.weight_hh.detach(),
            paddle.to_tensor(2 * np.asarray(jc.weight_hh.numpy())), 0)
