"""Tail bucketing (`FLAGS_train_tail_bucketing`) in paddle_tpu_torch's
`hapi.Model`, held to paddle_tpu's.

With `drop_last=False` and a dataset whose length is not a multiple of
the batch, both packages pad the last batch to the batch size by
repeating its last real row and fold a row mask into the loss on every
batch of the epoch. The padded rows enter BatchNorm's batch statistics,
so a BatchNorm network trains to other weights than it would unpadded:
the port must pad exactly as the JAX package does.

- A Linear -> BatchNorm1D -> ReLU -> Linear net, 10 rows, batch 4, one
  `fit` epoch with SGD(0.1) on CrossEntropyLoss, weights carried across
  by `load_reference_state`, the flag on and off: every weight and the
  `_mean` / `_variance` buffers within 1e-5 x max(1, max |ref|) (float32
  summation order, which BatchNorm over 4 rows, 3 of them one repeated
  row, amplifies to 9e-6 on the first Linear's weight), and
  `STAT_tail_pad_batches` moves alike;
- `CrossEntropyLoss(ignore_index=)`: the masked mean of per-row means
  weights the tail's rows alike (the reference's caveat), in both;
- `evaluate` and `predict` on a tail, and `logs["batch_size"]` and the
  metrics' sample count on the real rows;
- the `_tail_target` gates;
- a loss that gives only a scalar: one warning, the unpadded batches,
  the same weights as the JAX package.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework.monitor import stat_get as jstat_get
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu_torch import hapi, io, metric, nn, optimizer
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.models import load_reference_state

TOL = 1e-5


def _nets(bn=True):
    paddle.seed(0)
    if bn:
        j = jnn.Sequential(jnn.Linear(6, 8), jnn.BatchNorm1D(8), jnn.ReLU(),
                           jnn.Linear(8, 3))
        t = nn.Sequential(nn.Linear(6, 8), nn.BatchNorm1D(8), nn.ReLU(),
                          nn.Linear(8, 3))
    else:
        j = jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 3))
        t = nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))
    load_reference_state(t, {k: np.asarray(v.numpy())
                             for k, v in j.state_dict().items()})
    return j, t


def _data(n=10, seed=0, ignore=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype("float32")
    y = rng.randint(0, 3, (n,)).astype("int64")
    if ignore is not None:
        y[ignore] = -100
    return x, y


def _states(j, t):
    """(name, JAX value, port value in the JAX layout) of every entry."""
    ts = {k: v.detach().numpy() for k, v in t.state_dict().items()}
    out = []
    for k, v in j.state_dict().items():
        a, b = np.asarray(v.numpy()), ts[k]
        out.append((k, a, b.T if a.ndim == 2 else b))
    return out


def _assert_states(j, t, tol=TOL):
    for k, a, b in _states(j, t):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=tol * max(1.0, np.abs(a).max()),
                                   err_msg=k)


@pytest.fixture
def flag_state():
    jold = paddle.get_flags("FLAGS_train_tail_bucketing")
    told = tflags.get_flags("FLAGS_train_tail_bucketing")

    def set_both(on):
        paddle.set_flags({"FLAGS_train_tail_bucketing": on})
        tflags.set_flags({"FLAGS_train_tail_bucketing": on})
    yield set_both
    paddle.set_flags(jold)
    tflags.set_flags(told)


class _JRec(JCallback):
    def __init__(self):
        super().__init__()
        self.losses, self.sizes = [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))
        self.sizes.append(int(logs["batch_size"]))


class _TRec(hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses, self.sizes = [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))
        self.sizes.append(int(logs["batch_size"]))


def _fit_both(j, t, x, y, jloss, tloss, metrics=False, epochs=1):
    jm = paddle.Model(j)
    jm.prepare(paddle.optimizer.SGD(0.1, parameters=j.parameters()), jloss,
               JAccuracy() if metrics else None)
    jm._dist_ctx = None  # another file's fleet.init may be live
    tm = hapi.Model(t)
    tm.prepare(optimizer.SGD(0.1), tloss,
               metric.Accuracy() if metrics else None)
    jr, tr = _JRec(), _TRec()
    j0, t0 = (jstat_get("STAT_tail_pad_batches"),
              monitor.stat_get("STAT_tail_pad_batches"))
    jm.fit(paddle.io.TensorDataset([x, y]), batch_size=4, epochs=epochs,
           shuffle=False, verbose=0, log_freq=1, callbacks=[jr])
    tm.fit(io.TensorDataset([x, y]), batch_size=4, epochs=epochs,
           shuffle=False, verbose=0, log_freq=1, callbacks=[tr])
    pads = (jstat_get("STAT_tail_pad_batches") - j0,
            monitor.stat_get("STAT_tail_pad_batches") - t0)
    return jm, tm, jr, tr, pads


@pytest.mark.parametrize("on", [True, False], ids=["flag_on", "flag_off"])
def test_batchnorm_fit_over_a_tail_matches_jax(on, flag_state):
    flag_state(on)
    j, t = _nets()
    x, y = _data()
    _, _, jr, tr, pads = _fit_both(j, t, x, y, jnn.CrossEntropyLoss(),
                                   nn.CrossEntropyLoss())
    assert pads == ((1, 1) if on else (0, 0))
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    assert tr.sizes == jr.sizes == [4, 4, 2]
    _assert_states(j, t)


def test_ignore_index_rows_weighted_as_jax(flag_state):
    """Rows whose labels are all ignored count as a zero-loss row in the
    masked mean of both packages (the reference's documented caveat),
    so the per-step losses and the weights agree."""
    flag_state(True)
    j, t = _nets(bn=False)
    x, y = _data(ignore=[1, 5, 9])
    _, _, jr, tr, pads = _fit_both(
        j, t, x, y, jnn.CrossEntropyLoss(ignore_index=-100),
        nn.CrossEntropyLoss(ignore_index=-100))
    assert pads == (1, 1)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    _assert_states(j, t)


def test_evaluate_predict_and_metrics_on_a_tail(flag_state):
    flag_state(True)
    j, t = _nets()
    x, y = _data(n=11, seed=3)
    jm, tm, jr, tr, _ = _fit_both(j, t, x, y, jnn.CrossEntropyLoss(),
                                  nn.CrossEntropyLoss(), metrics=True)
    assert tr.sizes == jr.sizes == [4, 4, 3]
    _assert_states(j, t)
    j0, t0 = (jstat_get("STAT_tail_pad_batches"),
              monitor.stat_get("STAT_tail_pad_batches"))
    jev = jm.evaluate(paddle.io.TensorDataset([x, y]), batch_size=4,
                      verbose=0)
    tev = tm.evaluate(io.TensorDataset([x, y]), batch_size=4, verbose=0)
    assert set(tev) == set(jev) == {"loss", "acc"}
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=1e-5)
    assert tev["acc"] == jev["acc"]
    acc = tm._metrics[0]
    assert int(acc.count[0]) == 11   # the real rows only
    jp = jm.predict(paddle.io.TensorDataset([x]), batch_size=4,
                    stack_outputs=True)
    tp = tm.predict(io.TensorDataset([x]), batch_size=4, stack_outputs=True)
    assert np.asarray(tp).reshape(11, 3).shape == (11, 3)
    np.testing.assert_allclose(np.asarray(tp).reshape(11, 3),
                               np.asarray(jp).reshape(11, 3), rtol=1e-5,
                               atol=1e-5)
    assert (jstat_get("STAT_tail_pad_batches") - j0,
            monitor.stat_get("STAT_tail_pad_batches") - t0) == (2, 2)
    # predict_batch(nreal=) slices the padded rows off
    out = tm.predict_batch([np.concatenate([x[:2], x[1:2], x[1:2]])],
                           nreal=2)
    np.testing.assert_allclose(out, np.asarray(tp).reshape(11, 3)[:2],
                               rtol=1e-6, atol=1e-6)


class _Stream(io.IterableDataset):
    def __iter__(self):
        return iter([(np.zeros(2, "float32"),)] * 5)


@pytest.mark.parametrize("case,want", [
    ("tail", 4), ("divisible", None), ("drop_last", None),
    ("unsized", 4), ("flag_off", None), ("refused", None),
    ("refused_predict", 4)])
def test_tail_target_gates(case, want, flag_state):
    flag_state(case != "flag_off")
    n = 12 if case == "divisible" else 10
    data = io.TensorDataset([np.zeros((n, 2), "float32")])
    loader = io.DataLoader(_Stream() if case == "unsized" else data,
                           batch_size=4, drop_last=case == "drop_last")
    m = hapi.Model(nn.Linear(2, 2))
    if case.startswith("refused"):
        m._tail_maskable = False
    jm = paddle.Model(jnn.Linear(2, 2))
    jm._tail_maskable = m._tail_maskable
    jloader = paddle.io.DataLoader(
        _JStream() if case == "unsized" else paddle.io.TensorDataset(
            [np.zeros((n, 2), "float32")]),
        batch_size=4, drop_last=case == "drop_last")
    need = case != "refused_predict"
    assert m._tail_target(loader, need_mask=need) == want
    assert jm._tail_target(jloader, need_mask=need) == want


class _JStream(paddle.io.IterableDataset):
    def __iter__(self):
        return iter([(np.zeros(2, "float32"),)] * 5)


def test_scalar_loss_falls_back_once_as_jax(flag_state):
    """A loss without `reduction` that returns a scalar cannot take the
    row mask: both packages warn once, run the padded-size epoch's
    batches unpadded from there on, and train to the same weights; the
    port's failed attempt leaves no trace in the BatchNorm buffers."""
    flag_state(True)
    j, t = _nets()
    x, y = _data()

    def jloss(out, lab):
        return paddle.nn.functional.cross_entropy(out, lab).mean()

    def tloss(out, lab):
        return torch.nn.functional.cross_entropy(out, lab)

    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jm = paddle.Model(j)
        jm.prepare(paddle.optimizer.SGD(0.1, parameters=j.parameters()),
                   jloss)
        jm._dist_ctx = None  # another file's fleet.init may be live
        jm.fit(paddle.io.TensorDataset([x, y]), batch_size=4, epochs=2,
               shuffle=False, verbose=0)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tm = hapi.Model(t)
        tm.prepare(optimizer.SGD(0.1), tloss)
        tm.fit(io.TensorDataset([x, y]), batch_size=4, epochs=2,
               shuffle=False, verbose=0)

    def tail_warnings(ws):
        return [w for w in ws if "FLAGS_train_tail_bucketing" in
                str(w.message)]
    assert len(tail_warnings(jw)) == len(tail_warnings(tw)) == 1
    assert jm._tail_maskable is tm._tail_maskable is False
    _assert_states(j, t)
