"""paddle_tpu_torch's convolutions and pooling held to paddle_tpu's.

Inputs and weights are made with numpy from a seed and go through both
packages, float32 on the CPU:
- every functional's output within atol 1e-5 x max(1, max |ref|), rtol
  1e-5, and the gradients of a fixed random projection of it (the JAX
  package's eager tape against torch autograd) with respect to the input,
  the weight and the bias within 1e-4 x each one's largest |gradient|
  (summation order only);
- the convolutions over every padding form of the JAX package (an int,
  one int a dim, 2 x nd ints, (lo, hi) pairs, "SAME" at stride 2,
  which pads asymmetrically, and "VALID"), NHWC / NLC, groups,
  depthwise, dilation, 1-D and 3-D, and the transposes with
  `output_padding`, groups, dilation and asymmetric pads;
- pooling: max and average (exclusive or not, "SAME", pads torch
  refuses: asymmetric or wider than half the window), the shape under
  `ceil_mode=True` (the JAX package ignores it; ROADMAP C14), channel
  last, and the adaptive bins floor(i n / o) .. ceil((i + 1) n / o);
- the layers: state-dict names and shapes equal to the JAX layers',
  `bias_attr=False`, the JAX initializers' bounds and a seeded draw,
  and `load_reference_state` carrying a JAX net of a convolution, a
  grouped convolution, a transpose, a BatchNorm and a Linear (conv
  weights as they are, the Linear transposed, BN buffers by name).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as tF

ATOL = 1e-5
RTOL = 1e-5
GRAD_SHARE = 1e-4


def _rand(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        "float32")


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _both(jfn, tfn, arrays, seed=7):
    """Run jfn on JAX tensors and tfn on torch tensors of `arrays` (None
    passes through); compare the outputs, then the gradients of
    sum(out * r), r a seeded random array, for every array."""
    jt = [None if a is None else paddle.to_tensor(a, stop_gradient=False)
          for a in arrays]
    tt = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in arrays]
    jo, to = jfn(*jt), tfn(*tt)
    want = np.asarray(jo.numpy())
    assert tuple(to.shape) == want.shape
    _close(to.detach().numpy(), want, "output")
    r = _rand(seed, *want.shape)
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    for i, (j, t) in enumerate(zip(jt, tt)):
        if j is None:
            continue
        g = np.asarray(j.grad.numpy())
        err = np.abs(t.grad.numpy() - g).max()
        assert err <= GRAD_SHARE * max(np.abs(g).max(), 1e-30), (i, err)
    return to


CONV2D_CASES = {
    "int": dict(padding=1),
    "per_dim": dict(padding=[1, 2]),
    "flat_lo_hi": dict(padding=[0, 1, 2, 0]),
    "pairs": dict(padding=[(1, 0), (0, 2)]),
    "same_stride2": dict(padding="SAME", stride=2),
    "same_dilated": dict(padding="same", dilation=2),
    "valid": dict(padding="VALID", stride=(2, 1)),
    "nhwc": dict(padding=1, stride=2, data_format="NHWC"),
    "groups_dilation": dict(padding=2, dilation=2, groups=2),
    "depthwise": dict(padding=1, stride=2, groups=4),
}


@pytest.mark.parametrize("case", sorted(CONV2D_CASES))
def test_conv2d_matches_jax(case):
    kw = CONV2D_CASES[case]
    groups = kw.get("groups", 1)
    cin, cout = 4, (4 if case == "depthwise" else 6)
    shape = (2, 9, 8, cin) if kw.get("data_format") == "NHWC" \
        else (2, cin, 9, 8)
    arrays = [_rand(0, *shape), _rand(1, cout, cin // groups, 3, 3),
              _rand(2, cout)]
    _both(lambda x, w, b: jF.conv2d(x, w, b, **kw),
          lambda x, w, b: tF.conv2d(x, w, b, **kw), arrays)


@pytest.mark.parametrize("case", ["1d_nlc_same", "1d_pairs", "3d",
                                  "3d_ndhwc"])
def test_conv1d_conv3d_match_jax(case):
    if case == "1d_nlc_same":
        arrays, kw, fn = [_rand(0, 2, 11, 4), _rand(1, 6, 4, 3), None], \
            dict(padding="SAME", stride=2, data_format="NLC"), "conv1d"
    elif case == "1d_pairs":
        arrays, kw, fn = [_rand(0, 2, 4, 11), _rand(1, 6, 2, 3),
                          _rand(2, 6)], \
            dict(padding=[(2, 1)], groups=2), "conv1d"
    elif case == "3d":
        arrays, kw, fn = [_rand(0, 1, 3, 5, 6, 7), _rand(1, 4, 3, 3, 3, 3),
                          _rand(2, 4)], dict(padding=1, stride=2), "conv3d"
    else:
        arrays, kw, fn = [_rand(0, 1, 5, 6, 7, 3), _rand(1, 4, 3, 2, 3, 3),
                          None], dict(padding=[0, 1, 1, 1, 1, 0],
                                      data_format="NDHWC"), "conv3d"
    _both(lambda x, w, b: getattr(jF, fn)(x, w, b, **kw),
          lambda x, w, b: getattr(tF, fn)(x, w, b, **kw), arrays)


CONVT_CASES = {
    "stride2_opad": dict(stride=2, padding=1, output_padding=1),
    "groups": dict(stride=2, padding=0, groups=2),
    "dilation_opad": dict(stride=3, padding=1, dilation=2,
                          output_padding=2),
    "asymmetric": dict(stride=2, padding=[0, 1, 1, 0]),
    "pairs_opad_past_hi": dict(stride=2, padding=[(1, 0), (0, 0)],
                               output_padding=1),
    "nhwc": dict(stride=2, padding=1, output_padding=1, data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(CONVT_CASES))
def test_conv2d_transpose_matches_jax(case):
    kw = CONVT_CASES[case]
    groups = kw.get("groups", 1)
    shape = (2, 5, 6, 4) if kw.get("data_format") == "NHWC" \
        else (2, 4, 5, 6)
    arrays = [_rand(0, *shape), _rand(1, 4, 6 // groups, 3, 3),
              _rand(2, 6)]
    _both(lambda x, w, b: jF.conv2d_transpose(x, w, b, **kw),
          lambda x, w, b: tF.conv2d_transpose(x, w, b, **kw), arrays)


@pytest.mark.parametrize("nd", [1, 3])
def test_conv1d_conv3d_transpose_match_jax(nd):
    if nd == 1:
        arrays = [_rand(0, 2, 7, 4), _rand(1, 4, 3, 4), _rand(2, 3)]
        kw = dict(stride=2, padding=1, output_padding=1, data_format="NLC")
    else:
        arrays = [_rand(0, 1, 2, 3, 4, 3), _rand(1, 2, 3, 3, 2, 3), None]
        kw = dict(stride=2, padding=[1, 0, 1])
    jfn, tfn = (getattr(m, f"conv{nd}d_transpose") for m in (jF, tF))
    _both(lambda x, w, b: jfn(x, w, b, **kw),
          lambda x, w, b: tfn(x, w, b, **kw), arrays)


def test_conv_transpose_refuses_string_padding():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="string padding"):
        tF.conv2d_transpose(x, w, padding="SAME")
    with pytest.raises(ValueError, match="string padding"):
        jF.conv2d_transpose(paddle.to_tensor(x.numpy()),
                            paddle.to_tensor(w.numpy()), padding="SAME")


POOL_CASES = {
    "max_direct": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    "max_same": ("max_pool2d", dict(kernel_size=3, stride=2,
                                    padding="SAME")),
    "max_wide_pad": ("max_pool2d", dict(kernel_size=3, stride=1,
                                        padding=2)),
    "max_asymmetric": ("max_pool2d", dict(kernel_size=2, padding=[0, 1, 1,
                                                                  0])),
    "max_nhwc": ("max_pool2d", dict(kernel_size=2, stride=2,
                                    data_format="NHWC")),
    "avg_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1)),
    "avg_inclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1, exclusive=False)),
    "avg_exclusive_wide_pad": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                                  padding=2)),
    "avg_inclusive_pairs": ("avg_pool2d", dict(kernel_size=3,
                                               padding=[(0, 2), (1, 0)],
                                               exclusive=False)),
    "avg_same_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                              padding="SAME")),
    "avg_nhwc": ("avg_pool2d", dict(kernel_size=2, padding=1,
                                    data_format="NHWC")),
    "max_1d": ("max_pool1d", dict(kernel_size=3, stride=2, padding=1)),
    "avg_1d_nlc": ("avg_pool1d", dict(kernel_size=2, padding=1,
                                      data_format="NLC")),
    "max_3d": ("max_pool3d", dict(kernel_size=2, stride=2)),
    "avg_3d": ("avg_pool3d", dict(kernel_size=3, stride=2, padding=1)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    fn, kw = POOL_CASES[case]
    nd = int(fn[-2])
    spatial = {1: (11,), 2: (9, 8), 3: (5, 6, 7)}[nd]
    last = kw.get("data_format", "NC").startswith("N") and \
        not kw.get("data_format", "NC").startswith("NC")
    shape = (2,) + spatial + (3,) if last else (2, 3) + spatial
    _both(lambda x: getattr(jF, fn)(x, **kw),
          lambda x: getattr(tF, fn)(x, **kw), [_rand(3, *shape)])


def test_ceil_mode_and_return_mask_are_ignored():
    """The JAX package never reads `ceil_mode` or `return_mask`: floor'd
    sizes and values only, both packages (ROADMAP C14)."""
    x = _rand(4, 1, 2, 7, 7)
    kw = dict(kernel_size=2, stride=2, ceil_mode=True)
    got = tF.max_pool2d(torch.from_numpy(x), return_mask=True, **kw)
    want = jF.max_pool2d(paddle.to_tensor(x), return_mask=True, **kw)
    assert torch.is_tensor(got) and tuple(got.shape) == (1, 2, 3, 3)
    _close(got.numpy(), want.numpy())
    got = tF.avg_pool2d(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == tuple(
        jF.avg_pool2d(paddle.to_tensor(x), **kw).shape) == (1, 2, 3, 3)


ADAPTIVE_CASES = {
    "avg_2d": ("adaptive_avg_pool2d", (2, 3, 7, 9), dict(output_size=(3,
                                                                      4))),
    "avg_2d_none": ("adaptive_avg_pool2d", (2, 3, 7, 9),
                    dict(output_size=[5, None])),
    "avg_2d_nhwc": ("adaptive_avg_pool2d", (2, 7, 9, 3),
                    dict(output_size=2, data_format="NHWC")),
    "avg_1d": ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=4)),
    "avg_3d": ("adaptive_avg_pool3d", (1, 2, 5, 6, 7),
               dict(output_size=(2, 3, 4))),
    "max_2d": ("adaptive_max_pool2d", (2, 3, 7, 9), dict(output_size=(3,
                                                                      4))),
    "max_1d": ("adaptive_max_pool1d", (2, 3, 10), dict(output_size=3)),
    "max_3d": ("adaptive_max_pool3d", (1, 2, 5, 6, 7),
               dict(output_size=(2, 4, 3))),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE_CASES))
def test_adaptive_pooling_matches_jax(case):
    fn, shape, kw = ADAPTIVE_CASES[case]
    _both(lambda x: getattr(jF, fn)(x, **kw),
          lambda x: getattr(tF, fn)(x, **kw), [_rand(5, *shape)])


def test_adaptive_bins_are_floor_to_ceil():
    """7 positions into 3 bins: [0, 3), [2, 5), [4, 7)."""
    x = torch.arange(7.0).reshape(1, 1, 7)
    assert tF.adaptive_avg_pool1d(x, 3).flatten().tolist() == [1.0, 3.0,
                                                              5.0]
    assert tF.adaptive_max_pool1d(x, 3).flatten().tolist() == [2.0, 4.0,
                                                              6.0]


POOL_LAYERS = [("MaxPool2D", (3,), dict(stride=2, padding=1)),
               ("AvgPool2D", (2,), dict(exclusive=False)),
               ("AvgPool1D", (3,), dict(stride=1, padding=1)),
               ("MaxPool3D", (2,), {}),
               ("AdaptiveAvgPool2D", ((1, 1),), {}),
               ("AdaptiveMaxPool1D", (4,), dict(name="pool"))]


@pytest.mark.parametrize("name,args,kw", POOL_LAYERS,
                         ids=[p[0] for p in POOL_LAYERS])
def test_pooling_layers_match_jax(name, args, kw):
    nd = int(name[-2])
    x = _rand(6, *((2, 3) + (8,) * nd))
    got = getattr(tnn, name)(*args, **kw)(torch.from_numpy(x))
    want = getattr(jnn, name)(*args, **kw)(paddle.to_tensor(x))
    _close(got.numpy(), want.numpy(), name)


CONV_LAYERS = [("Conv1D", (4, 6, 3), dict(padding=1)),
               ("Conv2D", (4, 6, 3), dict(stride=2, bias_attr=False)),
               ("Conv2D", (4, 8, (3, 1)), dict(groups=2, padding="SAME")),
               ("Conv3D", (2, 4, 2), {}),
               ("Conv1DTranspose", (4, 6, 3), dict(stride=2)),
               ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1,
                                                   output_padding=1,
                                                   groups=2)),
               ("Conv3DTranspose", (2, 4, 2), dict(bias_attr=False))]


@pytest.mark.parametrize("name,args,kw", CONV_LAYERS,
                         ids=[f"{p[0]}-{i}" for i, p in
                              enumerate(CONV_LAYERS)])
def test_conv_layers_match_jax(name, args, kw):
    """Names and shapes of the state dicts equal; the weights carried by
    load_reference_state give the JAX layer's output; the port's own
    draw lies within the JAX laws' bounds, 1 / sqrt(fan_in)."""
    paddle.seed(11)
    ref = getattr(jnn, name)(*args, **kw)
    port = getattr(tnn, name)(*args, **kw)
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert ("bias" in want) == (kw.get("bias_attr") is not False)
    k = port._kernel_size
    fan_in = args[0] // kw.get("groups", 1) * int(np.prod(k))
    for p in port.parameters():
        assert float(p.abs().max()) <= 1.0 / np.sqrt(fan_in)
    load_reference_state(port, {n: np.asarray(v.numpy())
                                for n, v in ref.state_dict().items()})
    nd = port._nd
    x = _rand(12, *((2, 4 if args[0] == 4 else 2) + (6,) * nd))
    _close(port(torch.from_numpy(x)).detach().numpy(),
           ref(paddle.to_tensor(x)).numpy(), name)


def test_conv_layer_init_is_seeded_and_takes_attrs():
    g = torch.Generator().manual_seed(3)
    a = tnn.Conv2D(4, 6, 3)
    a.reset_parameters(g)
    b = tnn.Conv2D(4, 6, 3)
    b.reset_parameters(torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    c = tnn.Conv2D(4, 6, 3, weight_attr=tnn.initializer.Constant(0.5),
                   bias_attr=tnn.initializer.Constant(-1.0))
    assert float(c.weight.min()) == float(c.weight.max()) == 0.5
    assert float(c.bias.max()) == -1.0


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(3, 8, 3, padding=1)
        self.bn = jnn.BatchNorm2D(8)
        self.dw = jnn.Conv2D(8, 8, 3, padding=1, groups=4, bias_attr=False)
        self.up = jnn.Conv2DTranspose(8, 4, 2, stride=2)
        self.fc = jnn.Linear(4 * 8 * 8, 5)

    def forward(self, x):
        x = self.up(self.dw(jF.relu(self.bn(self.conv(x)))))
        return self.fc(x.reshape([x.shape[0], -1]))


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2D(3, 8, 3, padding=1)
        self.bn = tnn.BatchNorm2D(8)
        self.dw = tnn.Conv2D(8, 8, 3, padding=1, groups=4, bias_attr=False)
        self.up = tnn.Conv2DTranspose(8, 4, 2, stride=2)
        self.fc = tnn.Linear(4 * 8 * 8, 5)

    def forward(self, x):
        x = self.up(self.dw(tF.relu(self.bn(self.conv(x)))))
        return self.fc(torch.flatten(x, 1))


def test_load_reference_state_carries_convs_buffers_and_linear():
    """Conv weights (plain, grouped, transposed) copy as they are, the
    Linear transposed, the BatchNorm's `_mean` / `_variance` by name; the
    eval-mode outputs then agree."""
    paddle.seed(5)
    ref = _JNet()
    ref.bn._mean.set_value(_rand(8, 8))
    ref.bn._variance.set_value(np.abs(_rand(9, 8)) + 0.5)
    state = {n: np.asarray(v.numpy()) for n, v in ref.state_dict().items()}
    port = _TNet()
    load_reference_state(port, state)
    own = port.state_dict()
    assert sorted(own) == sorted(state)
    for n, v in own.items():
        want = state[n].T if n == "fc.weight" else state[n]
        assert np.array_equal(v.numpy(), want), n
    assert tuple(own["dw.weight"].shape) == (8, 2, 3, 3)
    assert tuple(own["up.weight"].shape) == (8, 4, 2, 2)
    x = _rand(10, 2, 3, 4, 4)
    ref.eval()
    port.eval()
    _close(port(torch.from_numpy(x)).detach().numpy(),
           ref(paddle.to_tensor(x)).numpy())
