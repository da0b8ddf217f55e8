"""paddle_tpu_torch.vision.models.YOLOv3 held to paddle_tpu's YOLOv3.

The JAX model is built from a seed and copied into the port's by
`models.load_reference_state` (every conv, BatchNorm and head parameter
and the BatchNorms' running buffers). On the same seeded numpy images
(2 x 3 x 64 x 64, width 4, 3 classes, training mode):
- the three head outputs within 1e-4 x max(1, max |ref|) (rtol 1e-4);
- `loss` (yolov3_loss summed over the scales, gts with padding rows)
  within rtol 1e-5 a sample;
- every parameter's gradient of the summed loss within 1e-3 x its
  largest |gradient| + 1e-5 x the model's largest (float32 summation
  orders of two conv libraries through 19 BatchNorms), and the running
  buffers after the step within rtol 1e-4, atol 1e-5.
The JAX side runs the JAX package's functional capture of the network
and its `loss` under one `jax.jit(jax.value_and_grad)`. Its yolov3_loss
builds the anchors with numpy's `asarray` and indexes them with a traced
array, which jit refuses, so for the duration its `asarray` makes a jnp
array instead (`_jittable_loss`: the same float32 values).

`yolov3_loss` alone, at two of the model's head shapes (so that the JAX
package's eager ops compile once for both tests): the loss within 1e-5 x
max(1, |ref|) and its gradient of sum(loss * w) (w standard normal) for
the head output within 1e-5 x max(1, max |ref|); one case with a padded
gt on the cell (n, anchor 0, 0, 0) of a real gt, one with `gt_score` and
no label smoothing.

In eval mode, `predict` (yolo_box on the three scales) within the
forward's limits, and `multiclass_nms` over it index-exact (labels and
order). Then the factory's `pretrained` warning, seeded construction and
the device rule.
"""
import contextlib
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.functional import functionalize
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.vision import models as jvm
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.vision import models as tvm
from paddle_tpu_torch.vision import ops as TV
from torch_ops_parity import QUICK, compare, r

OUT_ATOL = 1e-4
OUT_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-3
GRAD_FLOOR = 1e-5
BUF_RTOL = 1e-4
BUF_ATOL = 1e-5
CLASSES, WIDTH, SIDE = 3, 4, 64

X = np.random.RandomState(0).uniform(0, 1, (2, 3, SIDE, SIDE)).astype(
    np.float32)
# (cx, cy, w, h): image 0's first gt lies on the stride-8 head's cell
# (0, 0) at anchor 0, where its padded gts (w = h = 0) scatter too
GT = np.array([[[0.05, 0.05, 10 / 64, 13 / 64], [0.6, 0.4, 0.3, 0.45],
                [0.0, 0.0, 0.0, 0.0], [0.3, 0.8, 0.2, 0.1]],
               [[0.5, 0.5, 0.9, 0.95], [0.2, 0.7, 0.25, 0.4],
                [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]], np.float32)
LABEL = np.array([[1, 2, 0, 0], [0, 2, 0, 0]], np.int32)
IMG = np.array([[SIDE, SIDE], [SIDE, SIDE]], np.int32)
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
           116, 90, 156, 198, 373, 326]
# (head output, anchor mask, stride, keyword arguments), at the heads'
# shapes of the width-4 model on 64 x 64
LOSS_CASES = {
    "stride8": (r(8, 2, 3 * (5 + CLASSES), 8, 8), [0, 1, 2], 8, {}),
    "stride16#score": (r(9, 2, 3 * (5 + CLASSES), 4, 4), [3, 4, 5], 16,
                       {"gt_score": r(10, 2, 4, lo=0.5, hi=1.0),
                        "use_label_smooth": False}),
}


def _state(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    ref = jvm.YOLOv3(num_classes=CLASSES, width=WIDTH)
    port = tvm.YOLOv3(num_classes=CLASSES, width=WIDTH, device="cpu",
                      seed=None)
    load_reference_state(port, _state(ref))
    return ref, port


def _close(got, want, what, atol=OUT_ATOL, rtol=OUT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=what)


class _JnpAnchors:
    """A jnp array that takes a list index as numpy does."""

    def __init__(self, a):
        self.a = a

    def reshape(self, *shape):
        return _JnpAnchors(self.a.reshape(*shape))

    def __getitem__(self, i):
        return self.a[jnp.asarray(i) if isinstance(i, list) else i]


@contextlib.contextmanager
def _jittable_loss():
    """The JAX package's vision.ops with its anchors as jnp arrays
    (module docstring)."""
    shim = types.SimpleNamespace(**{n: getattr(np, n) for n in dir(np)
                                    if not n.startswith("__")})
    shim.asarray = lambda a, dtype=None: _JnpAnchors(jnp.asarray(a, dtype))
    saved, JV.np = JV.np, shim
    try:
        yield
    finally:
        JV.np = saved


def _jax_train_step(ref):
    """(outputs, loss a sample, {param: gradient of the summed loss},
    new buffers) of the JAX model in training mode."""
    apply_fn, pv, bv = functionalize(ref)

    def total(pv):
        outs, nb = apply_fn(pv, bv, jax.random.PRNGKey(0), True,
                            jnp.asarray(X))
        loss = ref.loss([Tensor(o) for o in outs], Tensor(jnp.asarray(GT)),
                        Tensor(jnp.asarray(LABEL)))
        return loss._value.sum(), (outs, loss._value, nb)
    with _jittable_loss():
        (_, (outs, loss, nb)), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True), compiler_options=QUICK)(pv)
    return ([np.asarray(o) for o in outs], np.asarray(loss),
            {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) for k, v in nb.items()})


def test_forward_loss_gradients_and_buffers_match_jax(pair):
    ref, port = pair
    jouts, jloss, jgrads, jbufs = _jax_train_step(ref)
    port.train()
    port.zero_grad()
    outs = port(torch.from_numpy(X))
    assert [tuple(o.shape) for o in outs] == [
        (2, 3 * (5 + CLASSES), s, s) for s in (2, 4, 8)]
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _close(o.detach().numpy(), jo, f"output {i}")
    loss = port.loss(outs, torch.from_numpy(GT), torch.from_numpy(LABEL))
    np.testing.assert_allclose(loss.detach().numpy(), jloss,
                               rtol=LOSS_RTOL)
    loss.sum().backward()
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(jgrads)
    for n, p in named.items():
        want = jgrads[n]
        got = p.grad.numpy()
        err = float(np.abs(got - want).max())
        assert err <= GRAD_SHARE * float(np.abs(want).max()) + \
            GRAD_FLOOR * top, (n, err)
    for n, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbufs[n], rtol=BUF_RTOL,
                                   atol=BUF_ATOL, err_msg=n)


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_yolov3_loss_and_gradient_match_jax(name):
    x, mask, ds, kw = LOSS_CASES[name]
    w = np.random.RandomState(1).standard_normal(2).astype(np.float32)

    def jloss(xv):
        jkw = {k: Tensor(jnp.asarray(v)) if isinstance(v, np.ndarray)
               else v for k, v in kw.items()}
        out = JV.yolov3_loss(Tensor(xv), Tensor(jnp.asarray(GT)),
                             Tensor(jnp.asarray(LABEL)), ANCHORS, mask,
                             CLASSES, 0.7, ds, **jkw)._value
        return (out * w).sum(), out
    with _jittable_loss():
        (_, want), jgrad = jax.jit(jax.value_and_grad(
            jloss, has_aux=True), compiler_options=QUICK)(jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = TV.yolov3_loss(tx, torch.from_numpy(GT), torch.from_numpy(LABEL),
                         ANCHORS, mask, CLASSES, 0.7, ds, **tkw)
    (got * torch.from_numpy(w)).sum().backward()
    compare(name, got, want, 1e-5)
    compare(name + " grad", tx.grad, jgrad, 1e-5)


def test_predict_and_nms_match_jax(pair):
    ref, port = pair
    # the training step moved the port's running buffers; start again
    # from the JAX model's
    load_reference_state(port, _state(ref))
    apply_fn, pv, bv = functionalize(ref)

    def predict(pv, bv, x):
        outs, _ = apply_fn(pv, bv, jax.random.PRNGKey(0), False, x)
        b, s = ref.predict([Tensor(o) for o in outs],
                           Tensor(jnp.asarray(IMG)))
        return b._value, s._value
    jb, js = jax.jit(predict, compiler_options=QUICK)(pv, bv,
                                                       jnp.asarray(X))
    port.eval()
    with torch.no_grad():
        tb, ts = port.predict(port(torch.from_numpy(X)),
                              torch.from_numpy(IMG))
    n = 3 * (2 * 2 + 4 * 4 + 8 * 8)
    assert tuple(tb.shape) == (2, n, 4) and tuple(ts.shape) == (2, n, 3)
    jbn, jsn = np.asarray(jb), np.asarray(js)
    _close(tb.numpy(), jbn, "boxes")
    _close(ts.numpy(), jsn, "scores")
    # NMS over the JAX package's own boxes and scores in both packages, so
    # that the kept rows can be compared index for index
    kw = dict(score_threshold=0.05, nms_top_k=40, keep_top_k=25,
              nms_threshold=0.45, background_label=-1)
    want, wnum = JV.multiclass_nms(paddle.to_tensor(jbn),
                                   paddle.to_tensor(jsn.transpose(0, 2, 1)),
                                   **kw)
    got, gnum = TV.multiclass_nms(torch.from_numpy(jbn),
                                  torch.from_numpy(jsn.transpose(0, 2, 1)
                                                   .copy()), **kw)
    np.testing.assert_array_equal(gnum.numpy(), np.asarray(wnum.numpy()))
    np.testing.assert_array_equal(got.numpy()[:, :2],
                                  np.asarray(want.numpy())[:, :2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=0, atol=1e-5 * SIDE)
    assert int(gnum.sum()) > 0


def test_factory_seed_and_device():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        m = tvm.yolov3(pretrained=True, num_classes=2, width=2,
                       device="cpu")
    assert any("pretrained" in str(w.message) for w in seen)
    a = tvm.YOLOv3(num_classes=2, width=2, device="cpu", seed=3)
    b = tvm.YOLOv3(num_classes=2, width=2, device="cpu", seed=3)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert not torch.equal(m.head3.weight, a.head3.weight)
    from paddle_tpu_torch import vision
    assert vision.YOLOv3 is tvm.YOLOv3 and vision.yolov3 is tvm.yolov3
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            tvm.YOLOv3(num_classes=2, width=2)
