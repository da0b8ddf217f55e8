"""The rest of the port's `nn` held to paddle_tpu's: activations,
containers, initializers, and the default device of the new models.

- Every activation of `nn.functional` (but `gumbel_softmax`) and every
  activation layer, `PReLU` included, on seeded numpy inputs: values to
  rtol 1e-5 / atol 1e-6 (float32; the two libraries' exp/tanh/erf
  differ in the last ulps) and the input's gradient of a fixed random
  projection to rtol 1e-5 / atol 1e-5 (the JAX package's eager tape
  against torch autograd; a derivative sums terms near 1 that cancel,
  e.g. the tanh GELU's, and the two write it differently). Each keeps
  its AMP hook under its op's name (an alias under the name of the op
  it calls: `relu_` is "relu", `swish` is "silu"): named in a custom
  white list an fp32 input comes out in bfloat16; named in a custom
  black list a bfloat16 input comes out in float32 (`softmax`, a
  STREAM_CAST_OUT op, in bfloat16), on both sides.
- `gumbel_softmax` on statistics: its rows are distributions (one-hot
  with `hard`, whose gradient is the soft one's), one generator seed
  gives one draw, and over 65 536 draws each class wins as often as
  softmax(x) says, within 3 sigma.
- Containers: child names, indexing (int, negative, slice, name),
  `append` / `insert` / `extend` / `update`, and state-dict keys equal
  to the JAX package's containers'.
- Initializers: `Constant` and `Assign` exactly, `_fans` and
  `calculate_gain` equal to the JAX package's, and the random ones by
  their first two moments on 65 536 draws from a fixed generator (3
  sigma, the variance's sigma estimated from the draws' fourth
  moment); `Linear(weight_attr=...)` fills the JAX [in, out] view and
  `bias_attr=False` builds no bias.
- With no CUDA device, `ErnieModel` and its heads built without a
  `device` raise (ROADMAP C6's rule).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import models, nn
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI

SHAPE = (2, 4, 3, 6)
N = 65536

# name -> (positional args, keyword args) for the functional and its layer
ACTS = {
    "relu": ((), {}), "relu6": ((), {}), "leaky_relu": ((0.1,), {}),
    "elu": ((0.5,), {}), "selu": ((), {}), "celu": ((0.7,), {}),
    "gelu": ((), {}), "silu": ((), {}), "swish": ((), {}),
    "sigmoid": ((), {}), "log_sigmoid": ((), {}),
    "hardsigmoid": ((), {}), "hardswish": ((), {}),
    "hardtanh": ((-0.5, 0.7), {}), "hardshrink": ((0.3,), {}),
    "softshrink": ((0.3,), {}), "tanhshrink": ((), {}),
    "softplus": ((2.0, 5.0), {}), "softsign": ((), {}), "tanh": ((), {}),
    "mish": ((), {}), "maxout": ((2,), {"axis": 1}),
    "thresholded_relu": ((0.4,), {}), "softmax": ((), {"axis": 1}),
    "log_softmax": ((), {"axis": -1}), "glu": ((), {"axis": -1}),
    "relu_": ((), {}),
}
LAYERS = {
    "ReLU": "relu", "ReLU6": "relu6", "LeakyReLU": "leaky_relu",
    "ELU": "elu", "SELU": "selu", "CELU": "celu", "Silu": "silu",
    "Swish": "swish", "Sigmoid": "sigmoid", "Hardsigmoid": "hardsigmoid",
    "Hardswish": "hardswish", "Hardtanh": "hardtanh",
    "Hardshrink": "hardshrink", "Softshrink": "softshrink",
    "Tanhshrink": "tanhshrink", "Softplus": "softplus",
    "Softsign": "softsign", "Tanh": "tanh", "Mish": "mish",
    "Maxout": "maxout", "Softmax": "softmax", "LogSoftmax": "log_softmax",
    "LogSigmoid": "log_sigmoid", "ThresholdedReLU": "thresholded_relu",
    "GLU": "glu",
}


def _x(seed=0, shape=SHAPE):
    return (np.random.RandomState(seed).standard_normal(shape) * 3).astype(
        "float32")


def _value_and_grad(jfn, tfn, x):
    """(JAX out, port out, JAX dx, port dx) of one function."""
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    tx = torch.from_numpy(x).requires_grad_()
    jo, to = jfn(jx), tfn(tx)
    w = np.random.RandomState(1).standard_normal(tuple(to.shape)).astype(
        "float32")
    (jo * paddle.to_tensor(w)).sum().backward()
    (to * torch.from_numpy(w)).sum().backward()
    return (np.asarray(jo.numpy()), to.detach().numpy(),
            np.asarray(jx.grad.numpy()), tx.grad.numpy())


def _check(jfn, tfn, x=None):
    jo, to, jg, tg = _value_and_grad(jfn, tfn, _x() if x is None else x)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


def test_every_activation_is_ported():
    want = set(JF.activation.__all__)
    assert set(TF.activation.__all__) == want
    assert set(ACTS) | {"prelu", "gumbel_softmax"} == want
    assert {n for n in jnn.layer.activation.__all__} == \
        set(LAYERS) | {"PReLU", "GELU"}
    assert all(hasattr(nn, n) for n in jnn.layer.activation.__all__)


@pytest.mark.parametrize("name", sorted(ACTS))
def test_functional_activation_matches_jax(name):
    args, kw = ACTS[name]
    _check(lambda v: getattr(JF, name)(v, *args, **kw),
           lambda v: getattr(TF, name)(v, *args, **kw))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_forms_match_jax(approximate):
    _check(lambda v: JF.gelu(v, approximate),
           lambda v: TF.gelu(v, approximate))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_activation_layer_matches_jax(name):
    args, kw = ACTS[LAYERS[name]]
    jl, tl = getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args, **kw)
    assert isinstance(tl, torch.nn.Module)
    _check(jl, tl)


@pytest.mark.parametrize("num,fmt", [(1, "NCHW"), (4, "NCHW"),
                                     (6, "NHWC")])
def test_prelu_matches_jax(num, fmt):
    paddle.seed(0)
    jl = jnn.PReLU(num, 0.3, data_format=fmt)
    tl = nn.PReLU(num, 0.3, data_format=fmt)
    assert torch.equal(tl.weight.detach(), torch.full((num,), 0.3))
    w = np.random.RandomState(2).uniform(0.1, 0.5, num).astype("float32")
    jl.weight.set_value(w)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    _check(jl, tl)
    x = _x()
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    v = np.random.RandomState(3).standard_normal(SHAPE).astype("float32")
    (jl(jx) * paddle.to_tensor(v)).sum().backward()
    (tl(tx) * torch.from_numpy(v)).sum().backward()
    np.testing.assert_allclose(tl.weight.grad.numpy(),
                               np.asarray(jl.weight.grad.numpy()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(ACTS) + ["prelu"])
def test_activation_amp_hooks_match_jax(name):
    """The op's name in a custom white list casts an fp32 input to
    bfloat16; in a custom black list, a bfloat16 input to float32."""
    args, kw = ACTS.get(name, ((), {}))
    op = {"relu_": "relu", "swish": "silu"}.get(name, name)
    x = _x()

    def run(fns, mod, dt, lists):
        t = fns[0](x, dt)
        with mod.auto_cast(**lists):
            out = (getattr(fns[1], name)(t, fns[2], *args, **kw)
                   if name == "prelu" else
                   getattr(fns[1], name)(t, *args, **kw))
        return str(out.dtype).replace("torch.", "").replace(
            "paddle.", "")

    jfns = (lambda a, dt: paddle.to_tensor(a).astype(dt), JF,
            paddle.to_tensor(np.float32([0.2])))
    tfns = (lambda a, dt: torch.from_numpy(a).to(getattr(torch, dt)), TF,
            torch.tensor([0.2]))
    for dt, lists, want in (
            ("float32", {"custom_white_list": [op]}, "bfloat16"),
            ("bfloat16", {"custom_black_list": [op]},
             "bfloat16" if op == "softmax" else "float32")):
        j = run(jfns, jamp, dt, lists)
        t = run(tfns, tamp, dt, lists)
        assert want in j and t == want, (name, dt, j, t)


def test_gumbel_softmax_statistics():
    x = torch.tensor([[0.5, -1.0, 1.5, 0.0]])
    g = torch.Generator().manual_seed(3)
    y = TF.gumbel_softmax(x.expand(N, 4), 0.7, generator=g)
    torch.testing.assert_close(y.sum(-1), torch.ones(N))
    a = TF.gumbel_softmax(x, generator=torch.Generator().manual_seed(9))
    b = TF.gumbel_softmax(x, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    xs = x.expand(N, 4).clone().requires_grad_()
    hard = TF.gumbel_softmax(xs, 1.0, hard=True,
                             generator=torch.Generator().manual_seed(5))
    assert set(hard.detach().unique().tolist()) == {0.0, 1.0}
    assert torch.equal(hard.detach().sum(-1), torch.ones(N))
    # Gumbel-max: argmax of x + g is softmax(x)-distributed
    freq = hard.detach().mean(0).numpy()
    p = torch.softmax(x[0], 0).numpy()
    assert (np.abs(freq - p) <= 3 * np.sqrt(p * (1 - p) / N)).all(), (
        freq, p)
    hard.sum().backward()   # straight-through: the soft rows' gradient
    assert xs.grad is not None and torch.isfinite(xs.grad).all()


def _keys(m):
    return sorted(m.state_dict())


def test_sequential_matches_jax():
    paddle.seed(0)
    j = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    t = nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2))
    assert _keys(t) == _keys(j) == ["0.bias", "0.weight", "2.bias",
                                    "2.weight"]
    assert len(t) == 3 and isinstance(t[-1], nn.Linear)
    assert isinstance(t[1:], nn.Sequential) and len(t[1:]) == 2
    named = nn.Sequential(("a", nn.Linear(3, 4)), ("b", nn.Tanh()))
    listed = nn.Sequential([("a", nn.Linear(3, 4)), ("b", nn.Tanh())])
    jnamed = jnn.Sequential(("a", jnn.Linear(3, 4)), ("b", jnn.Tanh()))
    assert _keys(named) == _keys(listed) == _keys(jnamed)
    assert isinstance(named["b"], nn.Tanh) and named[0] is named["a"]
    assert named(torch.ones(2, 3)).shape == (2, 4)


def test_layer_list_parameter_list_layer_dict_match_jax():
    paddle.seed(0)
    jl = jnn.LayerList([jnn.Linear(2, 2) for _ in range(2)])
    tl = nn.LayerList([nn.Linear(2, 2) for _ in range(2)])
    jl.append(jnn.Linear(2, 3))
    tl.append(nn.Linear(2, 3))
    jl.insert(1, jnn.Linear(2, 5))
    tl.insert(1, nn.Linear(2, 5))
    jl.extend([jnn.Linear(2, 6)])
    tl.extend([nn.Linear(2, 6)])
    assert _keys(tl) == _keys(jl)
    assert len(tl) == 5 and tl[1].out_features == 5
    assert tl[-1].out_features == 6 and len(tl[1:3]) == 2
    assert isinstance(tl[1:3], nn.LayerList)
    tl[0] = nn.Linear(2, 7)
    assert tl[0].out_features == 7
    assert [m.out_features for m in tl] == [7, 5, 2, 3, 6]
    jp = jnn.ParameterList([paddle.create_parameter([2], "float32")
                            for _ in range(2)])
    tp = nn.ParameterList([torch.nn.Parameter(torch.zeros(2))
                           for _ in range(2)])
    tp.append(torch.nn.Parameter(torch.ones(3)))
    jp.append(paddle.create_parameter([3], "float32"))
    assert _keys(tp) == _keys(jp) == ["0", "1", "2"]
    assert len(tp) == 3 and tuple(tp[2].shape) == (3,)
    jd = jnn.LayerDict({"a": jnn.Linear(2, 2)})
    td = nn.LayerDict({"a": nn.Linear(2, 2)})
    assert td.update([("b", nn.Linear(2, 3))]) is td
    jd.update([("b", jnn.Linear(2, 3))])
    assert _keys(td) == _keys(jd)
    assert list(td.keys()) == ["a", "b"] and "b" in td
    del td["a"]
    assert list(td) == ["b"] and len(td) == 1


def test_fans_and_gains_match_jax():
    for shape in ([], [5], [3, 7], [8, 4, 3, 3], [6, 2, 5]):
        assert TI._fans(shape) == JI._fans(shape)
    for nl, p in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("leaky_relu", None), ("selu", None), ("sigmoid", None),
                  ("unknown", None)):
        assert TI.calculate_gain(nl, p) == JI.calculate_gain(nl, p)


def test_constant_and_assign_exact():
    t = torch.empty(3, 4)
    assert TI.Constant(0.75)(t) is t and torch.equal(t, torch.full((3, 4),
                                                                   0.75))
    want = np.arange(12, dtype="float32").reshape(3, 4) / 7
    TI.Assign(want)(t)
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(JI.Assign(want)([3, 4]).astype("float32")))
    TI.Assign(torch.ones(3, 4, dtype=torch.float64))(t)
    assert torch.equal(t, torch.ones(3, 4))
    with pytest.raises(ValueError, match="shape"):
        TI.Assign(np.zeros((2, 2)))(t)


def _moments_ok(x, mean, var):
    """Sample mean and variance of `x` within 3 sigma of `mean` and
    `var` (the variance's sigma from the sample's fourth moment)."""
    x = x.double().flatten()
    n = x.numel()
    m = float(x.mean())
    v = float(x.var())
    se_var = float(((x - m) ** 2).std()) / math.sqrt(n)
    assert abs(m - mean) <= 3 * math.sqrt(var / n), (m, mean)
    assert abs(v - var) <= 3 * se_var, (v, var, se_var)


# the truncated standard normal's variance on [-2, 2]
_TRUNC_VAR = 1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi) / math.erf(
    2 / math.sqrt(2))


@pytest.mark.parametrize("init,shape,mean,var,bound", [
    (TI.Normal(0.5, 2.0), (256, 256), 0.5, 4.0, None),
    (TI.TruncatedNormal(1.0, 0.5), (256, 256), 1.0, 0.25 * _TRUNC_VAR,
     (0.0, 2.0)),
    (TI.Uniform(-0.5, 1.5), (256, 256), 0.5, 4.0 / 12, (-0.5, 1.5)),
    (TI.XavierUniform(), (128, 512), 0.0, (6 / 640) / 3,
     (-math.sqrt(6 / 640), math.sqrt(6 / 640))),
    (TI.XavierNormal(gain=2.0), (128, 512), 0.0, 4 * 2 / 640, None),
    (TI.KaimingUniform(), (128, 512), 0.0, (2 * 3 / 128) / 3,
     (-math.sqrt(6 / 128), math.sqrt(6 / 128))),
    (TI.KaimingNormal(nonlinearity="tanh"), (16, 16, 16, 16), 0.0,
     (5 / 3) ** 2 / 4096, None),
])
def test_random_initializers_by_moments(init, shape, mean, var, bound):
    t = torch.empty(shape)
    init(t, generator=torch.Generator().manual_seed(0))
    assert t.numel() == N
    _moments_ok(t, mean, var)
    if bound is not None:
        assert float(t.min()) >= bound[0] and float(t.max()) <= bound[1]
    again = torch.empty(shape)
    init(again, generator=torch.Generator().manual_seed(0))
    assert torch.equal(t, again)


def test_linear_and_embedding_take_attrs():
    lin = nn.Linear(128, 512, weight_attr=TI.KaimingUniform(),
                    bias_attr=TI.Constant(0.5))
    # fans of the JAX [in, out] layout: fan_in is 128, not 512
    assert float(lin.weight.abs().max()) > math.sqrt(6 / 512)
    assert float(lin.weight.abs().max()) <= math.sqrt(6 / 128)
    assert torch.equal(lin.bias.detach(), torch.full((512,), 0.5))
    assert nn.Linear(4, 3, bias_attr=False).bias is None
    assert nn.Linear(4, 3, False).bias is None
    emb = nn.Embedding(10, 4, padding_idx=2, weight_attr=TI.Constant(1.0))
    assert float(emb.weight[2].abs().sum()) == 0.0
    assert float(emb.weight[3].sum()) == 4.0


@pytest.mark.parametrize("name", ["ErnieModel",
                                  "ErnieForSequenceClassification",
                                  "ErnieForPretraining", "BertModel"])
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(UnavailableError):
        getattr(models, name)(models.ErnieConfig.tiny())
