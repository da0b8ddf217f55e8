"""paddle_tpu_torch.incubate held to paddle_tpu.incubate.

A small MLP (8 -> 16 -> 4, tanh) is built in both packages from one
seed, the JAX weights carried into the port by `load_reference_state`;
both train on the same seeded batches through the eager tape
(`loss.backward()`, `opt.step()`, `opt.clear_grad()`), and after every
step each parameter is held to the JAX package's within 1e-5 x max(1,
max |ref|):
- `LookAhead(Momentum, alpha 0.5, k 2)`, 4 steps (two slow-weight syncs);
- `GradientMergeOptimizer(Momentum, k_steps 2)`, averaged and summed, 4
  steps (two merged updates);
- `ModelAverage` beside SGD, 4 steps, then inside `apply()` (the
  average) and after it (restored);
- `RecomputeOptimizer(Adam)`, 2 steps (it forwards).
`TrainEpochRange` saves after each epoch and, made again after an
interruption, resumes at the next epoch with the saved weights and
optimizer state. `autotune.set_config` keeps its config.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import incubate as JI
from paddle_tpu_torch import incubate as TI
from paddle_tpu_torch.models import load_reference_state
from torch_ops_parity import on_the_cpu, r  # noqa: F401

TOL = 1e-5
STEPS = 4
BATCHES = [(r(10 + i, 6, 8), r(20 + i, 6, 4)) for i in range(STEPS)]


def _nets():
    paddle.seed(0)
    j = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.Tanh(),
                             paddle.nn.Linear(16, 4))
    t = ptt.nn.Sequential(ptt.nn.Linear(8, 16), ptt.nn.Tanh(),
                          ptt.nn.Linear(16, 4))
    load_reference_state(t, {k: np.asarray(v.numpy())
                             for k, v in j.state_dict().items()})
    return j, t


def _jstep(net, opt, x, y):
    out = net(paddle.to_tensor(x))
    loss = ((out - paddle.to_tensor(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _tstep(net, opt, x, y):
    loss = ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _held(j, t, what):
    want = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    for k, v in t.state_dict().items():
        w = want[k].T if k.endswith("weight") else want[k]
        np.testing.assert_allclose(
            v.detach().numpy(), w, rtol=0,
            atol=TOL * max(1.0, float(np.abs(w).max())),
            err_msg=f"{what} {k}")


WRAPPERS = {
    "lookahead": lambda P, ps: P.incubate.LookAhead(
        P.optimizer.Momentum(0.1, parameters=ps), alpha=0.5, k=2),
    "gradient_merge_avg": lambda P, ps: P.incubate.GradientMergeOptimizer(
        P.optimizer.Momentum(0.1, parameters=ps), k_steps=2),
    "gradient_merge_sum": lambda P, ps: P.incubate.GradientMergeOptimizer(
        P.optimizer.Momentum(0.05, parameters=ps), k_steps=2, avg=False),
    "recompute": lambda P, ps: P.incubate.RecomputeOptimizer(
        P.optimizer.Adam(0.01, parameters=ps)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_optimizer_matches_jax(name):
    j, t = _nets()
    jo = WRAPPERS[name](paddle, j.parameters())
    to = WRAPPERS[name](ptt, t.parameters())
    steps = 2 if name == "recompute" else STEPS
    for i, (x, y) in enumerate(BATCHES[:steps]):
        _jstep(j, jo, x, y)
        _tstep(t, to, x, y)
        _held(j, t, f"{name} step {i}")
    assert to.inner is not None and to.get_lr() == jo.get_lr()


def test_model_average_apply_and_restore_match_jax():
    j, t = _nets()
    jsgd = paddle.optimizer.SGD(0.1, parameters=j.parameters())
    tsgd = ptt.optimizer.SGD(0.1, parameters=t.parameters())
    jma = JI.ModelAverage(0.15, parameters=j.parameters())
    tma = TI.ModelAverage(0.15, parameters=t.parameters())
    for i, (x, y) in enumerate(BATCHES):
        _jstep(j, jsgd, x, y)
        _tstep(t, tsgd, x, y)
        jma.step()
        tma.step()
    _held(j, t, "trained")
    trained = t[0].weight.detach().clone()
    with jma.apply(), tma.apply():
        _held(j, t, "averaged")
        assert not torch.equal(t[0].weight, trained)
    _held(j, t, "restored")
    assert torch.equal(t[0].weight, trained)
    with tma.apply(need_restore=False):
        avg = t[0].weight.detach().clone()
    assert torch.equal(t[0].weight, avg)
    tma.restore()


def test_train_epoch_range_resumes_after_an_interruption(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("PADDLE_JOB_ID", "job7")
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    _, t = _nets()
    opt = ptt.optimizer.Momentum(0.1, parameters=t.named_parameters())
    rng = TI.TrainEpochRange(4, "fit").add(t, opt)
    assert rng.checker.valid and rng.get() == 0
    seen = []
    with pytest.raises(KeyboardInterrupt):
        for epoch in rng:
            seen.append(epoch)
            x, y = BATCHES[epoch]
            _tstep(t, opt, x, y)
            if epoch == 1:
                saved = {k: v.clone() for k, v in t.state_dict().items()}
                raise KeyboardInterrupt       # epoch 1 never finishes
            after0 = {k: v.clone() for k, v in t.state_dict().items()}
            vel0 = {k: v.clone() for k, v in opt.state_dict().items()
                    if torch.is_tensor(v)}
    assert seen == [0, 1]
    assert any(not torch.equal(saved[k], after0[k]) for k in saved)
    _, t2 = _nets()
    opt2 = ptt.optimizer.Momentum(0.1, parameters=t2.named_parameters())
    again = TI.TrainEpochRange(4, "fit").add(t2, opt2)
    assert again.get() == 1
    for k, v in t2.state_dict().items():
        assert torch.equal(v, after0[k]), k
    st = opt2.state_dict()
    assert st["global_step"] == 1 and vel0
    for k, v in vel0.items():
        assert torch.equal(torch.as_tensor(st[k]), v), k
    assert list(again) == [1, 2, 3]
    assert TI.TrainEpochRange(4, "fit").get() == 4
    assert (tmp_path / "job7" / "fit" / "meta.json").exists()


def test_autotune_and_names():
    assert TI.autotune.set_config({"kernel": {"enable": True}}) == \
        JI.autotune.set_config({"kernel": {"enable": True}})
    assert sorted(TI.__all__) == sorted(JI.__all__)
    assert TI.LookaheadOptimizer is TI.LookAhead
    assert ptt.incubate is TI
