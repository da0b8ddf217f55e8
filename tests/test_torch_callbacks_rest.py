"""paddle_tpu_torch's `EarlyStopping`, `VisualDL`, `summary`, `flops` and
`utils`, held to paddle_tpu's.

- `EarlyStopping` on the same trajectory (weights carried across by
  `load_reference_state`, SGD, float32 losses within 1e-5): training
  stops after the same epoch, for a minimised loss and a maximised
  accuracy (`mode="auto"`), and `save_best_model` is stored and not
  read in either;
- `VisualDL`: the same `train/<key>` records (tags, steps, values within
  rtol 1e-5, ignoring `wall_time`) and a `stat/` snapshot at each
  epoch's end; the port's adds no `STAT_train_host_syncs`;
- `summary` of `resnet18` and `LeNet`: the same parameter names and
  counts (the port prints a Linear weight as [out, in]); `flops` the same
  total, at 32 x 32 (resnet18) and 28 x 28 (LeNet);
- `utils`: `unique_name`, `try_import`, `deprecated`, `download`
  (resolves a local file, raises without one), `LogWriter`, `run_check`
  on the CPU when asked for and UnavailableError on the default device
  without a card.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.hapi.callbacks import EarlyStopping as JEarlyStopping
from paddle_tpu.hapi.callbacks import VisualDL as JVisualDL
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import hapi, io, metric, nn, optimizer, utils
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.framework.place import default_place, set_device
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.vision import models as tvm


def _nets():
    paddle.seed(1)
    j = jnn.Sequential(jnn.Linear(4, 16), jnn.ReLU(), jnn.Linear(16, 3))
    t = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 3))
    load_reference_state(t, {k: np.asarray(v.numpy())
                             for k, v in j.state_dict().items()})
    return j, t


def _data():
    rng = np.random.RandomState(4)
    x = rng.randn(16, 4).astype("float32")
    y = (x[:, 0] > 0).astype("int64") + (x[:, 1] > 1).astype("int64")
    return x, y


class _JEpochs(JCallback):
    def __init__(self):
        super().__init__()
        self.n = 0

    def on_epoch_end(self, epoch, logs=None):
        self.n += 1


class _TEpochs(hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.n = 0

    def on_epoch_end(self, epoch, logs=None):
        self.n += 1


def _fit_pair(jcbs, tcbs, epochs, lr=0.5, metrics=False):
    j, t = _nets()
    x, y = _data()
    jm = paddle.Model(j)
    jm.prepare(paddle.optimizer.SGD(lr, parameters=j.parameters()),
               jnn.CrossEntropyLoss(), JAccuracy() if metrics else None)
    jm._dist_ctx = None  # another file's fleet.init may be live
    tm = hapi.Model(t)
    tm.prepare(optimizer.SGD(lr), nn.CrossEntropyLoss(),
               metric.Accuracy() if metrics else None)
    jm.fit(paddle.io.TensorDataset([x, y]), batch_size=8, epochs=epochs,
           shuffle=False, verbose=0, log_freq=1, callbacks=jcbs)
    tm.fit(io.TensorDataset([x, y]), batch_size=8, epochs=epochs,
           shuffle=False, verbose=0, log_freq=1, callbacks=tcbs)
    return jm, tm


@pytest.mark.parametrize("kw", [
    dict(monitor="loss", patience=1, min_delta=0.05),
    dict(monitor="loss", patience=2, min_delta=10.0),
    dict(monitor="acc", patience=1, min_delta=0.0, save_best_model=False)],
    ids=["loss_plateau", "loss_never_better", "acc_max"])
def test_early_stopping_stops_at_the_same_epoch(kw):
    je, te = _JEpochs(), _TEpochs()
    jes, tes = JEarlyStopping(**kw), hapi.callbacks.EarlyStopping(**kw)
    _fit_pair([jes, je], [tes, te], epochs=30, lr=0.5,
              metrics=kw["monitor"] == "acc")
    assert te.n == je.n < 30
    assert tes.mode == jes.mode == ("max" if kw["monitor"] == "acc"
                                    else "min")
    assert tes.wait == jes.wait and tes.save_best_model == \
        jes.save_best_model
    np.testing.assert_allclose(tes.best, jes.best, rtol=1e-5)


def _records(path):
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_visualdl_records_match_jax(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _fit_pair([JVisualDL(jdir)], [hapi.callbacks.VisualDL(tdir)], epochs=2,
              metrics=True)
    jr, tr = _records(jdir), _records(tdir)

    def train(rs):
        return [(r["tag"], r["step"], r["value"]) for r in rs
                if r["tag"].startswith("train/")]
    jt, tt = train(jr), train(tr)
    assert [(a, b) for a, b, _ in tt] == [(a, b) for a, b, _ in jt]
    assert {a for a, _, _ in tt} == {"train/loss", "train/step",
                                     "train/batch_size", "train/acc"}
    np.testing.assert_allclose([v for _, _, v in tt], [v for _, _, v in jt],
                               rtol=1e-5)
    for rs in (jr, tr):
        stat_steps = {r["step"] for r in rs if r["tag"] ==
                      "stat/STAT_train_steps"}
        assert stat_steps == {0, 1}
    assert all("wall_time" in r for r in tr)
    # the flushes bring the device values over without counting a sync
    # of their own: a fit with VisualDL counts what one without does
    s0 = monitor.stat_get("STAT_train_host_syncs")
    _fit_pair([], [hapi.callbacks.VisualDL(str(tmp_path / "t2"))], epochs=2)
    s1 = monitor.stat_get("STAT_train_host_syncs")
    _fit_pair([], [], epochs=2)
    s2 = monitor.stat_get("STAT_train_host_syncs")
    assert s1 - s0 == s2 - s1


@pytest.mark.parametrize("name,shape", [("resnet18", [1, 3, 32, 32]),
                                        ("LeNet", [1, 1, 28, 28])])
def test_summary_and_flops_match_jax(name, shape, capsys):
    paddle.seed(0)
    j = getattr(jvm, name)()
    t = getattr(tvm, name)(device="cpu")
    js = paddle.summary(j)
    jout = capsys.readouterr().out
    ts = hapi.model_summary.summary(t)
    tout = capsys.readouterr().out
    assert ts == js
    jn = [n for n, _ in j.named_parameters()]
    tn = [n for n, _ in t.named_parameters()]
    assert tn == jn
    for n in jn:
        assert n in tout and n in jout
    assert paddle.flops(j, shape) == hapi.model_summary.flops(t, shape) > 0
    m = hapi.Model(t)
    assert m.summary() == js


def test_utils_match_jax(tmp_path, monkeypatch):
    from paddle_tpu import utils as jutils
    with utils.unique_name.guard():
        assert [utils.unique_name.generate("fc") for _ in range(2)] == \
            ["fc_0", "fc_1"]
    with jutils.unique_name.guard():
        assert jutils.unique_name.generate("fc") == "fc_0"
    assert utils.try_import("json") is json
    with pytest.raises(ImportError):
        utils.try_import("no_such_module_here")

    @utils.deprecated(update_to="g", since="2.0", reason="old")
    def f(v):
        return v + 1
    with pytest.warns(DeprecationWarning, match="f is deprecated"):
        assert f(1) == 2
    monkeypatch.setattr(utils.download, "WEIGHTS_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        utils.download.get_weights_path_from_url("http://x/w.pdparams")
    (tmp_path / "w.pdparams").write_bytes(b"0")
    assert utils.download.get_weights_path_from_url(
        "http://x/w.pdparams?v=1") == str(tmp_path / "w.pdparams")
    with utils.LogWriter(str(tmp_path / "log")) as w:
        w.add_scalar("a", 1.5, 3)
        w.add_text("b", "hi")
    recs = _records(str(tmp_path / "log"))
    assert [(r["tag"], r["step"]) for r in recs] == [("a", 3), ("b", 0)]
    prev = default_place()
    try:
        set_device("cpu")
        assert utils.run_check() == "CPU"
        if not torch.cuda.is_available():
            set_device("gpu")
            with pytest.raises(UnavailableError):
                utils.run_check()
    finally:
        set_device(prev)
