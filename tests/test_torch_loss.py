"""paddle_tpu_torch cross-entropy held to paddle_tpu's.

The same numpy logits and labels through `paddle_tpu.nn.functional.
cross_entropy` and the port's: hard labels with `ignore_index` holes,
with and without a class `weight`, each reduction, labels with and
without a trailing size-1 axis, and soft labels. float32, rtol 1e-6,
atol 1e-6 (the same log-softmax, summed in another order). Then
`CrossEntropyLoss`'s mutable `reduction`, and the gradient of the mean
against autograd through the written-out formula."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn.functional import cross_entropy

C = 7


def _data(shape, seed, holes=True):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal(shape + (C,)) * 2).astype(np.float32)
    labels = rng.randint(0, C, size=shape).astype(np.int64)
    if holes:
        labels.flat[::5] = -100
    return logits, labels


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(6,), (2, 5)])
def test_hard_labels_match_jax(reduction, weighted, shape):
    logits, labels = _data(shape, seed=len(shape) + weighted)
    w = np.linspace(0.5, 2.0, C).astype(np.float32) if weighted else None
    want = JF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        weight=paddle.to_tensor(w) if weighted else None,
        reduction=reduction).numpy()
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        weight=torch.from_numpy(w) if weighted else None,
                        reduction=reduction).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_label_with_trailing_axis_and_custom_ignore_index():
    logits, labels = _data((8,), seed=3, holes=False)
    labels[2] = 3
    want = JF.cross_entropy(paddle.to_tensor(logits),
                            paddle.to_tensor(labels[:, None]),
                            ignore_index=3).numpy()
    got = cross_entropy(torch.from_numpy(logits),
                        torch.from_numpy(labels[:, None]),
                        ignore_index=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_softmax", [True, False])
def test_soft_labels_match_jax(use_softmax):
    rng = np.random.RandomState(4)
    x = rng.standard_normal((5, C)).astype(np.float32)
    if not use_softmax:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    lab = rng.dirichlet(np.ones(C), size=5).astype(np.float32)
    want = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(lab),
                            soft_label=True, use_softmax=use_softmax).numpy()
    got = cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                        soft_label=True, use_softmax=use_softmax).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_layer_reduction_is_mutable_and_grad_is_right():
    logits, labels = _data((4, 6), seed=5)
    x = torch.from_numpy(logits).requires_grad_()
    y = torch.from_numpy(labels)
    loss = tnn.CrossEntropyLoss()
    mean = loss(x, y)
    loss.reduction = "none"
    per = loss(x, y)
    assert per.shape == (4, 6)
    valid = y != -100
    torch.testing.assert_close(mean, per[valid].mean())
    (g,) = torch.autograd.grad(mean, x)
    x2 = x.detach().clone().requires_grad_()
    lp = torch.log_softmax(x2, -1)
    picked = lp.gather(-1, y.clamp(min=0)[..., None])[..., 0]
    (g2,) = torch.autograd.grad(-(picked * valid).sum() / valid.sum(), x2)
    torch.testing.assert_close(g, g2)
