"""paddle_tpu_torch.metric held to paddle_tpu.metric, and the metric path
of `hapi.Model`.

- `Accuracy` (topk 1 and (1, 5), with tied scores), `Precision`,
  `Recall`, `Auc` and `accuracy()` on seeded numpy inputs, fed to both
  packages over several updates: every `compute`, `update` and
  `accumulate` result and every name exactly equal (both update on the
  host with the same numpy arithmetic; ties break the same way in
  `np.argsort`).
- `Model.fit` with `Accuracy` on `tests/test_hapi_model.py`'s linear
  classifier (16 -> 32 -> ReLU -> 4, Adam 0.01, batch 32, 3 epochs, no
  shuffle) against the JAX package's `Model.fit`: each epoch's loss to
  rtol 1e-5 and `acc` exactly, and `evaluate`'s.
- `train_batch` / `eval_batch` return `(loss, metrics)` with metrics
  prepared and `([loss], [])` without; rows a row mask drops never reach
  a metric.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as jmetric
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu_torch import hapi, io, metric, nn, optimizer
from paddle_tpu_torch.models import load_reference_state


def _jt(a):
    return paddle.to_tensor(a)


def _scores(seed, n=64, c=10):
    """Scores rounded to one decimal, so rows hold tied classes."""
    rng = np.random.RandomState(seed)
    return (np.round(rng.rand(n, c) * 10) / 10).astype("float32"), \
        rng.randint(0, c, size=(n,)).astype("int64")


@pytest.mark.parametrize("topk", [1, (1, 5)])
@pytest.mark.parametrize("label_shape", ["flat", "column"])
def test_accuracy_matches_jax(topk, label_shape):
    jm, tm = jmetric.Accuracy(topk), metric.Accuracy(topk)
    assert tm.name() == jm.name()
    for seed in range(3):
        pred, lab = _scores(seed)
        if label_shape == "column":
            lab = lab[:, None]
        jc = jm.compute(_jt(pred), _jt(lab))
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        np.testing.assert_array_equal(tc, np.asarray(jc.numpy()))
        assert tm.update(tc) == jm.update(jc)
    assert tm.accumulate() == jm.accumulate()
    tm.reset()
    assert tm.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


def test_binary_metrics_match_jax():
    rng = np.random.RandomState(4)
    for cls in ("Precision", "Recall", "Auc"):
        jm, tm = getattr(jmetric, cls)(), getattr(metric, cls)()
        assert tm.name() == jm.name()
        for _ in range(3):
            preds = rng.rand(50).astype("float32")
            labels = rng.randint(0, 2, size=(50,)).astype("int64")
            if cls == "Auc":
                preds = np.stack([1 - preds, preds], 1)
            jm.update(_jt(preds), _jt(labels))
            tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
        assert tm.accumulate() == jm.accumulate(), cls
    assert metric.Auc().accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy_matches_jax(k):
    pred, lab = _scores(7)
    want = jmetric.accuracy(_jt(pred), _jt(lab), k=k)
    got = metric.accuracy(torch.from_numpy(pred), torch.from_numpy(lab), k=k)
    assert got.dtype == np.float32
    assert float(got) == float(np.asarray(want.numpy()))


def _toy_classification(n=256, dim=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim).astype("float32") * 3
    y = rng.randint(0, classes, n)
    x = centers[y] + rng.randn(n, dim).astype("float32")
    return x.astype("float32"), y.astype("int64")


def _linear_pair():
    paddle.seed(0)
    ref = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 4))
    port = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


class _JEpochs(JCallback):
    def __init__(self):
        super().__init__()
        self.logs = []

    def on_epoch_end(self, epoch, logs=None):
        self.logs.append((float(logs["loss"]), logs["acc"]))


class _TEpochs(hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.logs, self.batch_keys = [], set()

    def on_train_batch_end(self, step, logs=None):
        self.batch_keys |= set(logs)

    def on_epoch_end(self, epoch, logs=None):
        self.logs.append((float(logs["loss"]), logs["acc"]))


def test_fit_with_accuracy_matches_jax():
    x, y = _toy_classification()
    ref, port = _linear_pair()
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.Adam(0.01, parameters=ref.parameters()),
               paddle.nn.CrossEntropyLoss(), jmetric.Accuracy())
    jm._dist_ctx = None  # another file's fleet.init may be live
    jrec = _JEpochs()
    jm.fit(paddle.io.TensorDataset([x, y]), batch_size=32, epochs=3,
           shuffle=False, verbose=0, callbacks=[jrec])
    tm = hapi.Model(port)
    tm.prepare(optimizer.Adam(0.01), nn.CrossEntropyLoss(),
               metric.Accuracy())
    trec = _TEpochs()
    tm.fit(io.TensorDataset([x, y]), batch_size=32, epochs=3,
           shuffle=False, verbose=0, callbacks=[trec])
    assert "acc" in trec.batch_keys
    assert len(trec.logs) == len(jrec.logs) == 3
    for (tl, ta), (jl, ja) in zip(trec.logs, jrec.logs):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert ta == ja
    jl = jm.evaluate(paddle.io.TensorDataset([x, y]), batch_size=64,
                     verbose=0)
    tl = tm.evaluate(io.TensorDataset([x, y]), batch_size=64, verbose=0)
    assert set(tl) == set(jl) == {"loss", "acc"}
    np.testing.assert_allclose(tl["loss"], jl["loss"], rtol=1e-5)
    assert tl["acc"] == jl["acc"] and tl["acc"] > 0.9


def test_batch_returns_and_row_mask():
    x, y = _toy_classification(n=8)
    _, port = _linear_pair()
    plain = hapi.Model(port).prepare(optimizer.SGD(0.0),
                                     nn.CrossEntropyLoss())
    loss, ms = plain.train_batch([x], [y])
    assert isinstance(loss, list) and len(loss) == 1 and ms == []
    acc = metric.Accuracy()
    tm = hapi.Model(port).prepare(optimizer.SGD(0.0), nn.CrossEntropyLoss(),
                                  [acc])
    loss, ms = tm.train_batch([x], [y])
    assert torch.is_tensor(loss) and loss.dim() == 0 and len(ms) == 1
    with torch.no_grad():
        logits = port(torch.from_numpy(x))
    hits = (logits.argmax(-1).numpy() == y)
    assert ms[0] == hits.mean()
    mask = np.array([1, 1, 1, 0, 1, 0, 0, 0], "float32")
    acc.reset()
    loss, ms = tm.train_batch([x], [y], loss_mask=mask)
    assert ms[0] == hits[mask > 0].mean()
    assert acc.count == [4]
    lv, ms = tm.eval_batch([x], [y], loss_mask=mask)
    assert ms[0] == hits[mask > 0].mean() and acc.count == [8]
    # a token mask [rows, T] keeps every row with any real token whole
    tok = np.zeros((8, 3), "float32")
    tok[[0, 2, 5], 1] = 1
    rows, idx = hapi.model._real_rows(tok)
    assert rows == 8 and list(idx) == [0, 2, 5]
