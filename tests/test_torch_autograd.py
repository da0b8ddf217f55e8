"""paddle_tpu_torch.autograd held to paddle_tpu.autograd on the same
functions and inputs: `grad`, `backward`, `PyLayer`, `vjp`, `jvp`,
`jacobian` and `hessian` agree within 1e-5 x max(1, max |ref|) (float32
both sides); `grad(create_graph=True)` raises NotImplementedError in
both, an unused input raises ValueError in both unless `allow_unused`;
`no_grad` / `enable_grad` / `is_grad_enabled` switch torch's state."""
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.autograd as ja
import paddle_tpu_torch.autograd as ta
from torch_ops_parity import compare, host, r

X = r(0, 3, 4)
Y = r(1, 3, 4)
TOL = 1e-5


def _jt(a):
    t = paddle.to_tensor(a)
    t.stop_gradient = False
    return t


def _tt(a):
    return torch.from_numpy(a.copy()).requires_grad_()


def test_names_match_the_reference():
    want = {n for n in dir(ja) if not n.startswith("_")}
    got = {n for n in dir(ta) if not n.startswith("_")}
    assert want <= got, want - got
    assert set(ja.__all__) <= set(ta.__all__)


def _fj(x, y):
    return (paddle.tanh(x) * y * y).sum()


def _ft(x, y):
    return (torch.tanh(x) * y * y).sum()


def test_grad_matches_jax():
    jx, jy = _jt(X), _jt(Y)
    want = ja.grad(_fj(jx, jy), [jx, jy])
    tx, ty = _tt(X), _tt(Y)
    got = ta.grad(_ft(tx, ty), [tx, ty])
    compare("grad", got, want, TOL)
    assert tx.grad is None and not got[0].requires_grad


def test_grad_with_grad_outputs_matches_jax():
    go = r(2, 3, 4)
    jx = _jt(X)
    want = ja.grad([paddle.tanh(jx)], [jx], grad_outputs=[paddle.to_tensor(
        go)])
    tx = _tt(X)
    got = ta.grad([torch.tanh(tx)], [tx],
                  grad_outputs=[torch.from_numpy(go)])
    compare("grad", got, want, TOL)


@pytest.mark.parametrize("mod,make,fn", [(ja, _jt, paddle.tanh),
                                         (ta, _tt, torch.tanh)],
                         ids=["jax", "port"])
def test_grad_refusals(mod, make, fn):
    x, y = make(X), make(Y)
    with pytest.raises(NotImplementedError):
        mod.grad(fn(x).sum(), [x], create_graph=True)
    with pytest.raises(ValueError):
        mod.grad(fn(x).sum(), [x, y])
    got = mod.grad(fn(x).sum(), [x, y], allow_unused=True)
    assert got[1] is None


def test_backward_accumulates_as_jax():
    jx, jy = _jt(X), _jt(Y)
    ja.backward(_fj(jx, jy))
    ja.backward(_fj(jx, jy))
    tx, ty = _tt(X), _tt(Y)
    ta.backward(_ft(tx, ty))
    ta.backward(_ft(tx, ty))
    compare("backward", [tx.grad, ty.grad], [jx.grad, jy.grad], TOL)


class _JCube(ja.PyLayer):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x)
        ctx.k = k
        return x * x * x * k

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor
        return g * 3 * x * x * ctx.k


class _TCube(ta.PyLayer):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x)
        ctx.k = k
        return x * x * x * k

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor()
        return g * 3 * x * x * ctx.k


def test_pylayer_matches_jax():
    jx = _jt(X)
    jout = _JCube.apply(jx, 2.0)
    (jout * jout).sum().backward()
    tx = _tt(X)
    tout = _TCube.apply(tx, 2.0)
    (tout * tout).sum().backward()
    compare("pylayer", [tout.detach(), tx.grad], [jout, jx.grad], TOL)
    assert isinstance(ta.PyLayerContext(), ta.PyLayerContext)
    assert type(ta.PyLayer) is ta.PyLayerMeta


def _gj(x):
    return paddle.tanh(x) * x.sum()


def _gt(x):
    return torch.tanh(x) * x.sum()


def test_vjp_and_jvp_match_jax():
    v = r(3, 3, 4)
    compare("vjp", ta.vjp(_gt, torch.from_numpy(X), torch.from_numpy(v)),
            ja.vjp(_gj, paddle.to_tensor(X), paddle.to_tensor(v)), TOL)
    compare("vjp#ones", ta.vjp(_gt, torch.from_numpy(X)),
            ja.vjp(_gj, paddle.to_tensor(X)), TOL)
    compare("jvp", ta.jvp(_gt, torch.from_numpy(X), torch.from_numpy(v)),
            ja.jvp(_gj, paddle.to_tensor(X), paddle.to_tensor(v)), TOL)
    xs = [X, Y]
    compare("vjp#two",
            ta.vjp(lambda a, b: a * b.exp(), [torch.from_numpy(a)
                                              for a in xs]),
            ja.vjp(lambda a, b: a * b.exp(), [paddle.to_tensor(a)
                                              for a in xs]), TOL)


def test_jacobian_and_hessian_match_jax():
    x = X[0]
    compare("jacobian", ta.jacobian(_gt, torch.from_numpy(x)),
            ja.jacobian(_gj, paddle.to_tensor(x)), TOL)
    compare("jacobian#two",
            ta.jacobian(lambda a, b: a * b, [torch.from_numpy(x),
                                             torch.from_numpy(Y[0])]),
            ja.jacobian(lambda a, b: a * b, [paddle.to_tensor(x),
                                             paddle.to_tensor(Y[0])]), TOL)

    def hj(a):
        return (paddle.tanh(a) * a).sum()

    def ht(a):
        return (torch.tanh(a) * a).sum()
    compare("hessian", ta.hessian(ht, torch.from_numpy(x)),
            ja.hessian(hj, paddle.to_tensor(x)), TOL)
    with pytest.raises(ValueError):
        ta.hessian(torch.tanh, torch.from_numpy(x))
    for mod, fn, arg in ((ta, ht, torch.from_numpy(x)),
                         (ja, hj, paddle.to_tensor(x))):
        with pytest.raises(NotImplementedError):
            mod.hessian(fn, arg, create_graph=True)
        with pytest.raises(NotImplementedError):
            mod.jacobian(fn, arg, create_graph=True)


def test_grad_mode_switches():
    assert ta.is_grad_enabled()
    with ta.no_grad():
        assert not ta.is_grad_enabled()
        assert not (_tt(X) * 2).requires_grad
        with ta.enable_grad():
            assert ta.is_grad_enabled()
    assert ta.is_grad_enabled()
    assert host(ta.vjp(_gt, torch.from_numpy(X))[1]).shape == X.shape
