"""nn's common functionals and layers, the ops `nn.functional` re-exports
from `ops/extra_ops.py`, and `nn.Layer`: paddle_tpu_torch held to
paddle_tpu on the same numpy inputs.

- Every name of `nn.functional.common`'s `__all__` that this slice adds,
  and `affine_grid`, `channel_shuffle`, `gather_tree`, `max_unpool2d`,
  `pixel_unshuffle`: values (integer outputs exact, float within
  1e-5 x max(1, max |ref|)) and the gradients of a random projection
  of the output for every float input (the JAX side of every case
  under one shared `jax.jit`).
- `interpolate` in every mode, up and down, as the JAX package's
  `jax.image.resize` (ROADMAP C20): `align_corners` changes nothing, and
  a bilinear downsample is antialiased (it differs from torch's).
- `one_hot` gives a zero row for an id out of range; `sequence_mask`
  with `maxlen=None` gives int32 whatever `dtype` says.
- The common layers against the JAX package's, values and input
  gradients; `Bilinear`'s weight layout.
- `nn.Layer`: a torch module with the reference's methods.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_ops_parity import (compare, jax_jit_grads_many,  # noqa: F401
                              on_the_cpu, r, ri)

JF = paddle.nn.functional
TF = ptt.nn.functional
TOL = 1e-5


X4 = r(0, 2, 4, 6, 8)
GRID = r(1, 2, 5, 7, 2, lo=-1.2, hi=1.2)
THETA = r(2, 2, 2, 3, lo=-1.0, hi=1.0)
COLS = r(3, 2, 4 * 3 * 3, 24)                # fold: 2 x (C 4, k 3x3) x L

CASES = {
    # (args, kwargs, gradients)
    "one_hot": ((np.array([[0, 3], [5, -1]], np.int32), 4), {}, True),
    "label_smooth": ((r(4, 3, 5, lo=0.0, hi=1.0),), {"epsilon": 0.2},
                     True),
    "label_smooth#prior": ((r(4, 3, 5, lo=0.0, hi=1.0),
                            r(5, 1, 5, lo=0.0, hi=1.0)), {}, True),
    "pad": ((X4, [1, 2, 0, 3]), {"mode": "reflect"}, True),
    "interpolate": ((X4,), {"size": [9, 13], "mode": "bilinear"}, True),
    "interpolate#align_corners": ((X4,), {"size": [3, 5], "mode": "bilinear",
                                          "align_corners": True}, True),
    "upsample": ((X4,), {"scale_factor": 2, "mode": "nearest"}, True),
    "cosine_similarity": ((r(6, 3, 7), r(7, 3, 7)), {"axis": 1}, True),
    "pairwise_distance": ((r(8, 3, 7), r(9, 3, 7)), {"p": 3.0}, True),
    "normalize": ((r(10, 3, 7),), {"axis": -1}, True),
    "pixel_shuffle": ((r(11, 2, 8, 3, 5),), {"upscale_factor": 2}, True),
    "pixel_shuffle#nhwc": ((r(11, 2, 3, 5, 8), 2), {"data_format": "NHWC"},
                           True),
    "unfold": ((X4, [3, 2]), {"strides": [1, 2], "paddings": [1, 0, 2, 1],
                              "dilations": [2, 1]}, True),
    "fold": ((COLS, [6, 7], 3), {"strides": [1, 2], "paddings": [1, 1]},
             True),
    "bilinear": ((r(12, 5, 3), r(13, 5, 4), r(14, 6, 3, 4), r(15, 6)), {},
                 True),
    "sequence_mask": ((np.array([2, 0, 5], np.int32),), {"maxlen": 6,
                                                         "dtype": "float32"},
                      True),
    "sequence_mask#none": ((np.array([2, 0, 5], np.int32),), {}, True),
    "grid_sample": ((X4[:, :, :5], GRID), {"align_corners": False}, True),
    "grid_sample#nearest": ((X4[:, :, :5], GRID), {"mode": "nearest"},
                            True),
    "grid_sample#border": ((X4[:, :, :5], GRID),
                           {"padding_mode": "border"}, True),
    "grid_sample#reflect": ((X4[:, :, :5], GRID),
                            {"padding_mode": "reflection",
                             "align_corners": False}, True),
    "affine_grid": ((THETA, [2, 3, 5, 4]), {}, True),
    "affine_grid#centres": ((THETA, [2, 3, 5, 4]),
                            {"align_corners": False}, True),
    "channel_shuffle": ((r(16, 2, 6, 3, 2), 3), {}, True),
    "pixel_unshuffle": ((r(17, 2, 3, 4, 6), 2), {}, True),
    "gather_tree": ((ri(18, 5, 2, 3, lo=0, hi=9), ri(19, 5, 2, 3, lo=0,
                                                     hi=3)), {}, True),
}
# the dropouts are random: held on their statistics below
DROPOUTS = ("dropout2d", "dropout3d", "alpha_dropout")
ADDED = ("dropout2d dropout3d alpha_dropout one_hot label_smooth pad "
         "interpolate upsample cosine_similarity pixel_shuffle unfold "
         "bilinear pairwise_distance normalize sequence_mask fold "
         "grid_sample affine_grid channel_shuffle gather_tree max_unpool2d "
         "pixel_unshuffle").split()


def test_every_added_name_has_a_case():
    covered = {n.split("#")[0] for n in CASES} | set(DROPOUTS) | {
        "max_unpool2d"}
    assert sorted(covered) == sorted(ADDED)
    assert set(ADDED) <= set(TF.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_matches_jax(name):
    _run(name)


def _unpool_args():
    """Each 2 x 2 window's max of an 8 x 8 map and its flat position."""
    x = r(20, 2, 3, 8, 8)
    win = x.reshape(2, 3, 4, 2, 4, 2).transpose(0, 1, 2, 4, 3, 5)
    arg = win.reshape(2, 3, 4, 4, 4).argmax(-1)
    rows = np.arange(4)[:, None] * 2 + arg // 2
    cols = np.arange(4)[None, :] * 2 + arg % 2
    idx = (rows * 8 + cols).astype(np.int32)
    pooled = np.take_along_axis(win.reshape(2, 3, 4, 4, 4),
                                arg[..., None], -1)[..., 0]
    return (pooled, idx, 2)


INTERPOLATE = [
    ("nearest", [13, 5], "NCHW"), ("nearest", [3, 16], "NCHW"),
    ("bilinear", [13, 17], "NCHW"), ("bilinear", [3, 2], "NCHW"),
    ("bicubic", [11, 19], "NCHW"), ("bicubic", [2, 3], "NCHW"),
    ("area", [2, 5], "NCHW"), ("bilinear", [9, 3], "NHWC"),
    ("linear", [17], "NCL"), ("linear", [3], "NCL"),
    ("trilinear", [5, 3, 9], "NCDHW")]


def _interpolate_case(mode, size, df):
    shape = {"NCHW": (2, 3, 6, 8), "NHWC": (2, 6, 8, 3), "NCL": (2, 3, 8),
             "NCDHW": (1, 2, 4, 6, 5)}[df]
    return ((r(21, *shape),), {"size": size, "mode": mode,
                               "data_format": df}, True)


def _functional_cases():
    """{key: (args, kwargs, gradients)} of every functional case; the
    key's part before the first "#" names the function."""
    cases = dict(CASES)
    cases["max_unpool2d"] = (_unpool_args(), {}, True)
    for mode, size, df in INTERPOLATE:
        cases[f"interpolate#{mode}#{size}#{df}"] = _interpolate_case(
            mode, size, df)
    return cases


def _float_pos(args, grad=True):
    return [i for i, a in enumerate(args) if grad and isinstance(
        a, np.ndarray) and a.dtype == np.float32]


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's value and input gradients of every functional
    and layer case, under one `jax.jit`."""
    cases = {}
    for key, (args, kw, grad) in _functional_cases().items():
        cases[key] = ((lambda *a, fn=key.split("#")[0], kw=kw:
                       getattr(JF, fn)(*a, **kw)),
                      args, _float_pos(args, grad), None, 5)
    for i, (name, cargs, kw, ins) in enumerate(LAYERS):
        layer = getattr(paddle.nn, name)(*cargs, **kw)
        cases[f"layer {i}"] = (layer, ins, _float_pos(ins), layer, 5)
    return jax_jit_grads_many(cases)


def _check(key, fn, args, grad=True):
    """fn on `args` as torch tensors against the JAX case `key`: the
    value, and the gradients of sum(out * w) for the float inputs, w as
    `jax_jit_grads_many` draws it from seed 5."""
    want, jgrads, _ = _jax()[key]
    grad_pos = _float_pos(args, grad)
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
             for a in args]
    for i in grad_pos:
        targs[i].requires_grad_()
    got = fn(*targs)
    compare(key, got, want, TOL)
    if not grad_pos:
        return
    w = np.random.RandomState(5).standard_normal(
        tuple(got.shape)).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    for i, jg in zip(grad_pos, jgrads):
        # no path to an input (nearest sampling's grid) is a zero
        # gradient in the JAX package
        g = targs[i].grad if targs[i].grad is not None else \
            torch.zeros_like(targs[i])
        compare(key + " grad", g, jg, TOL)


def _run(key):
    args, kw, grad = _functional_cases()[key]
    fn = getattr(TF, key.split("#")[0])
    _check(key, lambda *a: fn(*a, **kw), args, grad)


def test_max_unpool2d_matches_jax():
    """Each 2 x 2 window's max scattered back to its flat position of
    the 8 x 8 map."""
    _run("max_unpool2d")


@pytest.mark.parametrize("mode,size,df", INTERPOLATE)
def test_interpolate_every_mode_matches_jax(mode, size, df):
    _run(f"interpolate#{mode}#{size}#{df}")


def test_interpolate_ignores_align_corners_and_antialiases():
    """In both packages (the port held to the JAX side with
    `align_corners` by the case `interpolate#align_corners` above): a
    bilinear downsample with `align_corners` is the one without, and is
    antialiased."""
    a, b = (JF.interpolate(paddle.to_tensor(X4), size=[3, 5],
                           mode="bilinear", align_corners=c)
            for c in (True, False))
    np.testing.assert_array_equal(np.asarray(a.numpy()),
                                  np.asarray(b.numpy()))
    x = torch.from_numpy(r(22, 1, 2, 16, 16))
    a = TF.interpolate(x, size=[4, 4], mode="bilinear", align_corners=True)
    b = TF.interpolate(x, size=[4, 4], mode="bilinear", align_corners=False,
                       align_mode=1)
    assert torch.equal(a, b)
    plain = torch.nn.functional.interpolate(x, size=[4, 4], mode="bilinear",
                                            align_corners=False)
    # each output of a 4x bilinear downsample averages over a 8 x 8
    # triangle window (torch's plain bilinear reads 2 x 2 pixels)
    assert float((a - plain).abs().max()) > 0.1
    smooth = torch.nn.functional.interpolate(x, size=[4, 4],
                                             mode="bilinear",
                                             align_corners=False,
                                             antialias=True)
    assert torch.allclose(a, smooth, atol=1e-5)


def test_one_hot_out_of_range_is_a_zero_row():
    got = TF.one_hot(torch.tensor([1, 4, -1, 7]), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().sum(1), [1, 0, 0, 0])
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.tensor([1, 4]), 4)


def test_sequence_mask_without_maxlen_is_int32():
    lens = torch.tensor([2, 3], dtype=torch.int32)
    got = TF.sequence_mask(lens, dtype="float32")
    assert got.dtype == torch.int32 and got.shape == (2, 3)
    want = JF.sequence_mask(paddle.to_tensor(lens.numpy()), dtype="float32")
    assert np.asarray(want.numpy()).dtype == np.int32


def test_dropouts_on_statistics():
    """dropout2d / 3d zero whole channels with probability p and scale
    the kept by 1 / (1 - p); alpha_dropout keeps the mean and variance of
    a standard normal input; p 0 or eval returns the input."""
    ptt.seed(3)
    x = torch.ones(64, 32, 4, 4)
    y = TF.dropout2d(x, 0.25)
    per = y.reshape(64, 32, -1)
    assert torch.all((per == 0).all(-1) | (per == 1 / 0.75).all(-1))
    assert abs(float((per[..., 0] == 0).float().mean()) - 0.25) < 0.04
    z = TF.dropout3d(torch.ones(64, 64, 2, 3, 3), 0.5).reshape(64, 64, -1)
    assert torch.all((z == 0).all(-1) | (z == 2).all(-1))
    assert abs(float((z[..., 0] == 0).float().mean()) - 0.5) < 0.04
    n = torch.randn(400_000)
    a = TF.alpha_dropout(n, 0.2)
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1) < 0.01
    assert TF.alpha_dropout(n, 0.2, training=False) is n
    assert TF.dropout2d(x, 0.0) is x
    layers = [ptt.nn.Dropout2D(0.5), ptt.nn.Dropout3D(0.5),
              ptt.nn.AlphaDropout(0.5)]
    for layer, v in zip(layers, (x, torch.ones(2, 3, 2, 2, 2), n)):
        layer.eval()
        assert layer(v) is v


LAYERS = [
    # (name, constructor args, kwargs, inputs)
    ("Flatten", (), {}, (X4,)),
    ("Flatten", (2, 3), {}, (X4,)),
    ("Identity", (7,), {}, (X4,)),
    ("Upsample", (), {"scale_factor": 2, "mode": "bicubic"}, (X4,)),
    ("UpsamplingNearest2D", (), {"size": [5, 11]}, (X4,)),
    ("UpsamplingBilinear2D", (), {"size": [3, 12]}, (X4,)),
    ("Pad1D", ([1, 2],), {"mode": "replicate"}, (r(23, 2, 3, 5),)),
    ("Pad2D", ([1, 0, 2, 1],), {"value": 0.5}, (X4,)),
    ("Pad3D", ([1, 0, 2, 1, 0, 1],), {"mode": "circular"},
     (r(24, 1, 2, 3, 4, 5),)),
    ("CosineSimilarity", (), {"axis": 2}, (X4, X4[::-1].copy())),
    ("PairwiseDistance", (), {"keepdim": True}, (r(25, 4, 6), r(26, 4, 6))),
    ("PixelShuffle", (2,), {}, (r(11, 2, 8, 3, 5),)),
    ("Unfold", ([2, 3],), {"strides": 2}, (X4,)),
]


@pytest.mark.parametrize("i", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
def test_common_layers_match_jax(i):
    name, cargs, kw, ins = LAYERS[i]
    layer = getattr(ptt.nn, name)(*cargs, **kw)
    assert isinstance(layer, ptt.nn.Layer)
    _check(f"layer {i}", layer, ins)


def test_bilinear_layer_keeps_the_reference_layout():
    """The reference's weight [out, in1, in2] (F.bilinear's case holds
    the function on it), which is torch's layout too."""
    port = ptt.nn.Bilinear(3, 4, 5)
    assert sorted(port.state_dict()) == ["bias", "weight"]
    assert tuple(port.weight.shape) == (5, 3, 4)
    a, b = torch.from_numpy(r(27, 6, 3)), torch.from_numpy(r(28, 6, 4))
    got = port(a, b)
    torch.testing.assert_close(got, TF.bilinear(a, b, port.weight, port.bias))
    torch.testing.assert_close(got, torch.nn.functional.bilinear(
        a, b, port.weight, port.bias))


class _Net(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.w = self.create_parameter([3, 4])
        self.b = self.create_parameter([4], is_bias=True)
        self.frozen = self.create_parameter(
            [2], attr=ptt.ParamAttr(trainable=False, need_clip=False,
                                    learning_rate=0.5))
        self.none = self.create_parameter([2], attr=False)
        self.add_sublayer("inner", ptt.nn.Linear(4, 2))
        self.register_buffer("steps", torch.zeros(1))
        self.register_buffer("scratch", torch.zeros(2), persistable=False)

    def forward(self, x):
        return self.inner(x @ self.w + self.b)


def test_layer_is_a_torch_module_with_the_reference_methods():
    net = _Net()
    assert isinstance(net, torch.nn.Module) and net.none is None
    assert float(net.b.abs().sum()) == 0.0            # Constant(0) bias
    bound = (6 / (3 + 4)) ** 0.5                      # XavierUniform
    assert float(net.w.abs().max()) <= bound
    assert net.frozen.requires_grad is False
    assert net.frozen.need_clip is False and net.w.need_clip is True
    assert net.frozen.optimize_attr["learning_rate"] == 0.5
    assert sorted(net.state_dict()) == ["b", "frozen", "inner.bias",
                                        "inner.weight", "steps", "w"]
    assert [n for n, _ in net.named_sublayers()] == ["inner"]
    assert net.sublayers(include_self=True)[0] is net
    assert net.full_name() == "_net"
    seen = []
    h = net.register_forward_post_hook(
        lambda layer, ins, out: seen.append(out.shape) or out * 2)
    x = torch.ones(5, 3)
    y = net(x)
    h.remove()
    torch.testing.assert_close(y, net(x) * 2)
    assert seen == [(5, 2)]
    y.sum().backward()
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.astype("float64")
    assert net.w.dtype == torch.float64
    net.to(device="cpu", dtype="float32", blocking=False)
    net.to("cpu")
    assert net.w.dtype == torch.float32 and net.w.device.type == "cpu"
    other = _Net()
    missing, unexpected = other.set_state_dict(
        {k: v.detach().numpy() for k, v in net.state_dict().items()
         if k != "steps"})
    assert missing == ["steps"] and unexpected == []
    torch.testing.assert_close(other.w, net.w)
    with pytest.raises(TypeError):
        net.add_parameter("bad", torch.ones(2))


def test_layer_parameters_go_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    ptt.set_device("gpu")
    try:
        from paddle_tpu_torch.framework.errors import UnavailableError
        with pytest.raises(UnavailableError):
            _Net()
        with pytest.raises(UnavailableError):
            ptt.nn.LSTM(2, 2)
    finally:
        ptt.set_device("cpu")
