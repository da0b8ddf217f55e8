"""paddle_tpu_torch's `vision.models` held to paddle_tpu's on bridged
weights.

Each JAX model is built from a seed and copied into the port's by
`load_reference_state`; numpy inputs made from a seed go through both,
float32 on the CPU, in training mode (BatchNorm on the batch's
statistics, dropout 0). The JAX side runs the JAX package's functional
capture (`framework.functional.functionalize`, the path its
`hapi.Model` jits) under `jax.jit(jax.value_and_grad)`.
- `LeNet` (at its own 28 x 28, batch 2; its Linear takes 16 x 5 x 5),
  `resnet18` and `mobilenet_v2` at 32 x 32, batch 8 (at batch 2 the
  last BatchNorms see two values a channel, and their outputs flip sign
  on fp32 noise): outputs within atol 1e-4 x max(1, max |ref|), rtol
  1e-4; every parameter's gradient of a fixed random projection within
  1e-3 x its largest |gradient| + 1e-5 x the model's largest (float32
  summation orders of two conv libraries through up to 52 BatchNorms;
  0.17 of it seen, MobileNetV2's `features.2.conv.2.conv.weight`; the
  floor is for the biases of BatchNorms that feed a training-mode
  BatchNorm, whose exact gradient is 0);
  the BatchNorm buffers after the step within rtol 1e-4, atol 1e-5;
- `resnet50` forward at 64 x 64 (training mode) with its buffers, and
  in eval mode, at those limits (at 32 x 32 its last stage normalises 1 x
  1 maps, 2 or 8 values a channel, and turns fp32 noise into sign flips);
- `vgg16(batch_norm=True)`: its state-dict names and shapes (the port
  built on the "meta" device, holding no values: the 25088 x 4096
  classifier is too large for the CPU suite), and a features-only
  (`num_classes=0`) forward;
- `hapi.Model.fit` of a small conv + BatchNorm net with Momentum
  (0.1; 0.01 under O1, where at 0.1 the two packages' bf16 trajectories
  drift apart over 12 steps), `CrossEntropyLoss` and
  `Accuracy(topk=(1, 5))`, epoch by epoch: every step's loss (fp32 rtol
  1e-4; O1 bf16 within test_torch_amp.py's limit, 2e-2 x max(1,
  |ref|)), `acc_top1` / `acc_top5` (fp32 exactly; O1 within one sample of
  the 32, a bf16 near-tie at a top-k boundary), the BatchNorm buffers
  (fp32 rtol 1e-4; O1 within 2e-2 x max(1, |ref|)); then `evaluate` and
  `predict` in eval mode, and `save` / `load` carrying the buffers;
- seeded construction, `pretrained` warning, and the C6 rule: without
  `device=`, a model raises where there is no card.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework.functional import functionalize
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import hapi, io, metric, nn, optimizer
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.vision import models as tvm

OUT_ATOL = 1e-4
OUT_RTOL = 1e-4
GRAD_SHARE = 1e-3
GRAD_FLOOR = 1e-5
BUF_RTOL = 1e-4
BUF_ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        "float32")


def _state(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=OUT_RTOL,
        atol=OUT_ATOL * max(1.0, float(np.abs(want).max())), err_msg=what)


def _linear_weights(port):
    return {f"{n}.weight" for n, m in port.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _pair(name, seed=0, **kw):
    paddle.seed(seed)
    ref = getattr(jvm, name)(**kw)
    port = getattr(tvm, name)(device="cpu", **kw)
    load_reference_state(port, _state(ref))
    for net, drop in ((ref, jnn.Dropout), (port, nn.Dropout)):
        for m in (net.sublayers() if net is ref else net.modules()):
            if isinstance(m, drop):
                m.p = 0.0
    return ref, port


def _jax_step(ref, x, r, training=True):
    """(output, {param: gradient of sum(out * r)}, new buffers) of the JAX
    model through its functional capture, jitted."""
    apply_fn, pv, bv = functionalize(ref)

    def loss(pv, bv, x):
        out, nb = apply_fn(pv, bv, jax.random.PRNGKey(0), training, x)
        return (out * r).sum(), (out, nb)

    (_, (out, nb)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        pv, bv, x)
    return (np.asarray(out), {k: np.asarray(v) for k, v in g.items()},
            {k: np.asarray(v) for k, v in nb.items()})


def _check_buffers(port, want):
    for n, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[n], rtol=BUF_RTOL,
                                   atol=BUF_ATOL, err_msg=n)


def _check_step(ref, port, x, seed=7):
    """One training-mode step of both on x (10 classes): output, every
    gradient and the buffers after it."""
    r = _rand(seed, x.shape[0], 10)
    jout, jgrads, jbufs = _jax_step(ref, x, r)
    before = {n: b.clone() for n, b in port.named_buffers()}
    port.train()
    tout = port(torch.from_numpy(x))
    _close(tout.detach().numpy(), jout, "output")
    (tout * torch.from_numpy(r)).sum().backward()
    linear = _linear_weights(port)
    top = max(np.abs(g).max() for g in jgrads.values())
    assert sorted(n for n, _ in port.named_parameters()) == sorted(jgrads)
    for n, p in port.named_parameters():
        got = p.grad.numpy().T if n in linear else p.grad.numpy()
        lim = GRAD_SHARE * np.abs(jgrads[n]).max() + GRAD_FLOOR * top
        assert np.abs(got - jgrads[n]).max() <= lim, (
            n, np.abs(got - jgrads[n]).max(), lim)
    _check_buffers(port, jbufs)
    assert all(not torch.equal(before[n], b)
               for n, b in port.named_buffers())


@pytest.mark.parametrize("name,kw,shape", [
    ("LeNet", {}, (2, 1, 28, 28)),
    ("resnet18", dict(num_classes=10), (8, 3, 32, 32)),
    ("mobilenet_v2", dict(num_classes=10), (8, 3, 32, 32)),
], ids=["lenet", "resnet18", "mobilenet_v2"])
def test_outputs_gradients_and_buffers_match_jax(name, kw, shape):
    ref, port = _pair(name, **kw)
    _check_step(ref, port, _rand(1, *shape))


def test_resnet50_forward_matches_jax():
    """Training mode (its buffers after the step), then eval mode over
    the JAX model's buffers."""
    ref, port = _pair("resnet50", num_classes=10)
    x = _rand(2, 8, 3, 64, 64)
    apply_fn, pv, bv = functionalize(ref)
    fwd = jax.jit(lambda pv, bv, x, training: apply_fn(
        pv, bv, jax.random.PRNGKey(0), training, x), static_argnums=3)
    jout, jbufs = fwd(pv, bv, x, True)
    port.train()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), np.asarray(jout), "train")
    _check_buffers(port, {k: np.asarray(v) for k, v in jbufs.items()})
    jout, _ = fwd(pv, {k: v for k, v in jbufs.items()}, x, False)
    port.eval()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), np.asarray(jout), "eval")
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(v.shape)) for v in pv.values())


def test_vgg16_names_shapes_and_features_forward():
    """vgg16(batch_norm=True) state names and shapes: the port's full
    model on the meta device against the JAX features (num_classes=0)
    plus the JAX classifier's [in, out] Linears (vgg.py's 512 x 7 x 7 ->
    4096 -> 4096 -> classes, transposed in the port); then the features
    forward, which the avgpool takes to 7 x 7."""
    paddle.seed(3)
    ref = jvm.vgg16(batch_norm=True, num_classes=0)
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    for i, (fi, fo) in zip((0, 3, 6), ((25088, 4096), (4096, 4096),
                                       (4096, 1000))):
        want[f"classifier.{i}.weight"] = (fo, fi)
        want[f"classifier.{i}.bias"] = (fo,)
    full = tvm.vgg16(batch_norm=True, device="meta", seed=None)
    assert {k: tuple(v.shape) for k, v in full.state_dict().items()} == want
    assert sum(1 for m in full.modules() if isinstance(m, nn.BatchNorm2D)) \
        == 13
    port = tvm.vgg16(batch_norm=True, num_classes=0, device="cpu")
    load_reference_state(port, _state(ref))
    x = _rand(4, 2, 3, 32, 32)
    apply_fn, pv, bv = functionalize(ref)
    jout, jbufs = jax.jit(lambda pv, bv, x: apply_fn(
        pv, bv, jax.random.PRNGKey(0), True, x))(pv, bv, x)
    port.train()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 512, 7, 7)
    _close(out.numpy(), np.asarray(jout), "features")
    _check_buffers(port, {k: np.asarray(v) for k, v in jbufs.items()})


def test_resnet_family_configs_and_seeding():
    """Depths and widths as the JAX package's (parameter counts at
    num_classes 10, built on the meta device), one seed one draw, another
    seed another; `pretrained=True` warns and still builds."""
    for name in ("resnet18", "resnet34", "resnet101", "resnet152",
                 "wide_resnet50_2", "mobilenet_v1"):
        port = getattr(tvm, name)(num_classes=10, device="meta", seed=None)
        paddle.seed(0)
        assert sorted(port.state_dict()) == sorted(
            getattr(jvm, name)(num_classes=10).state_dict()), name
    a = tvm.resnet18(num_classes=10, device="cpu", seed=4).state_dict()
    b = tvm.resnet18(num_classes=10, device="cpu", seed=4).state_dict()
    c = tvm.resnet18(num_classes=10, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    w = a["layer1.0.conv1.weight"]
    assert float(w.abs().max()) <= 1 / np.sqrt(64 * 9)
    assert float(a["fc.bias"].abs().max()) == 0.0
    assert torch.equal(a["bn1._variance"], torch.ones(64))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        tvm.resnet18(pretrained=True, num_classes=2, device="meta",
                     seed=None)
    assert any("pretrained" in str(w.message) for w in got)


def test_models_raise_without_a_card():
    """C6: the default device is the card; without one, no model builds
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    for build in (tvm.resnet50, tvm.LeNet, tvm.mobilenet_v2,
                  lambda: tvm.vgg11(num_classes=0)):
        with pytest.raises(UnavailableError):
            build()


# -- hapi.Model.fit ----------------------------------------------------------

class _JSmall(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv1 = jnn.Conv2D(3, 8, 3, padding=1)
        self.bn1 = jnn.BatchNorm2D(8)
        self.pool = jnn.MaxPool2D(2, 2)
        self.conv2 = jnn.Conv2D(8, 16, 3, stride=2, padding=1,
                                bias_attr=False)
        self.bn2 = jnn.BatchNorm2D(16)
        self.gap = jnn.AdaptiveAvgPool2D(1)
        self.fc = jnn.Linear(16, 10)

    def forward(self, x):
        x = self.pool(jnn.functional.relu(self.bn1(self.conv1(x))))
        x = self.gap(jnn.functional.relu(self.bn2(self.conv2(x))))
        return self.fc(x.reshape([x.shape[0], -1]))


class _TSmall(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2D(3, 8, 3, padding=1)
        self.bn1 = nn.BatchNorm2D(8)
        self.pool = nn.MaxPool2D(2, 2)
        self.conv2 = nn.Conv2D(8, 16, 3, stride=2, padding=1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(16)
        self.gap = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(16, 10)

    def forward(self, x):
        x = self.pool(nn.functional.relu(self.bn1(self.conv1(x))))
        x = self.gap(nn.functional.relu(self.bn2(self.conv2(x))))
        return self.fc(torch.flatten(x, 1))


def _buffers(net):
    return {n: np.asarray(b.numpy()).copy() for n, b in net.named_buffers()}


class _JRec(JCallback):
    def __init__(self, net):
        super().__init__()
        self.net, self.losses, self.epochs = net, [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append((logs["acc_top1"], logs["acc_top5"],
                            _buffers(self.net)))


class _TRec(hapi.callbacks.Callback):
    def __init__(self, net):
        super().__init__()
        self.net, self.losses, self.epochs = net, [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append((logs["acc_top1"], logs["acc_top5"],
                            _buffers(self.net)))


def _near(got, want, amp_level, rtol):
    got, want = np.asarray(got), np.asarray(want)
    if amp_level is None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=BUF_ATOL)
    else:
        assert (np.abs(got - want) <= 2e-2 * np.maximum(
            1.0, np.abs(want))).all(), (got, want)


@pytest.mark.parametrize("amp_level", [None, "O1"])
def test_fit_evaluate_predict_match_jax(amp_level, tmp_path):
    paddle.seed(6)
    ref, port = _JSmall(), _TSmall()
    load_reference_state(port, _state(ref))
    rng = np.random.RandomState(8)
    x = rng.standard_normal((32, 3, 16, 16)).astype("float32")
    y = rng.randint(0, 10, size=(32,)).astype("int64")
    x += y[:, None, None, None].astype("float32") * 0.2
    lr = 0.1 if amp_level is None else 0.01
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.Momentum(lr, parameters=ref.parameters()),
               jnn.CrossEntropyLoss(), JAccuracy(topk=(1, 5)),
               amp_configs=amp_level)
    jm._dist_ctx = None  # another file's fleet.init may be live
    tm = hapi.Model(port)
    tm.prepare(optimizer.Momentum(lr), nn.CrossEntropyLoss(),
               metric.Accuracy(topk=(1, 5)), amp_configs=amp_level)
    jrec, trec = _JRec(ref), _TRec(port)
    jm.fit(paddle.io.TensorDataset([x, y]), batch_size=8, epochs=3,
           shuffle=False, log_freq=1, verbose=0, callbacks=[jrec])
    tm.fit(io.TensorDataset([x, y]), batch_size=8, epochs=3, shuffle=False,
           log_freq=1, verbose=0, callbacks=[trec])
    assert len(trec.losses) == len(jrec.losses) == 12
    _near(trec.losses, jrec.losses, amp_level, 1e-4)
    assert trec.losses[-1] < trec.losses[0]
    # under O1 a sample whose logits tie at a top-k boundary within the
    # packages' bf16 rounding may count in one and not the other
    acc_tol = 0.0 if amp_level is None else 1.0 / len(y)
    for (t1, t5, tb), (j1, j5, jb) in zip(trec.epochs, jrec.epochs):
        assert abs(t1 - j1) <= acc_tol and abs(t5 - j5) <= acc_tol
        assert sorted(tb) == sorted(jb)
        for n in jb:
            _near(tb[n], jb[n], amp_level, BUF_RTOL)
    jlogs = jm.evaluate(paddle.io.TensorDataset([x, y]), batch_size=8,
                        verbose=0)
    tlogs = tm.evaluate(io.TensorDataset([x, y]), batch_size=8, verbose=0)
    assert set(tlogs) == set(jlogs) == {"loss", "acc_top1", "acc_top5"}
    _near(tlogs["loss"], jlogs["loss"], amp_level, 1e-4)
    for k in ("acc_top1", "acc_top5"):
        assert abs(tlogs[k] - jlogs[k]) <= acc_tol, k
    tpred = tm.predict(io.TensorDataset([x]), batch_size=8,
                       stack_outputs=True)
    jpred = jm.predict(paddle.io.TensorDataset([x]), batch_size=8,
                       stack_outputs=True)
    _near(np.asarray(tpred).reshape(32, 10),
          np.asarray(jpred).reshape(32, 10), amp_level, 1e-4)
    acc = metric.Accuracy(topk=(1, 5))
    acc.update(acc.compute(np.asarray(tpred).reshape(32, 10), y))
    assert acc.accumulate() == [tlogs["acc_top1"], tlogs["acc_top5"]]
    # eval mode read the buffers and left them as fit did
    assert all(np.array_equal(v, trec.epochs[-1][2][n])
               for n, v in _buffers(port).items())
    tm.save(str(tmp_path / "small"))
    other = _TSmall()
    tm2 = hapi.Model(other)
    tm2.prepare(optimizer.Momentum(0.1), nn.CrossEntropyLoss())
    tm2.load(str(tmp_path / "small"))
    assert all(np.array_equal(v, trec.epochs[-1][2][n])
               for n, v in _buffers(other).items())
    np.testing.assert_array_equal(
        np.asarray(tm2.predict(io.TensorDataset([x]), batch_size=8,
                               stack_outputs=True)).reshape(32, 10),
        np.asarray(tpred).reshape(32, 10))
