"""The port's DistributeTranspiler (`paddle_tpu_torch.distributed.
DistributeTranspiler`) held to the JAX package's on the CPU: the same
static train Program (fc -> fc, MSE) built in both packages from the
same weights, transpiled over two pservers for one trainer, 4 steps.
The servers are the port's, bound to 127.0.0.1:0 and given their tables
once the transpiler has placed them; the JAX trainer reaches them over
the same wire. The port's trajectory is held to the JAX package's and to
the port's local `Executor.run`, within rtol 2e-4 / atol 2e-5 (the
JAX package's `tests/test_transpiler.py:89-92`), for SGD and Adam."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu.distributed import DistributeTranspiler as JTranspiler
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.distributed import DistributeTranspiler
from paddle_tpu_torch.distributed.ps import PsServer

from torch_static_parity import (copy_scope, on_the_cpu,  # noqa: F401
                                 port_exe, static_both)

TOL = dict(rtol=2e-4, atol=2e-5)


def _program(P, st, opt):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [8, 4], "float32")
        y = st.data("y", [8, 1], "float32")
        h = st.nn.fc(x, 6, activation="tanh")
        pred = st.nn.fc(h, 1)
        loss = P.mean((pred - y) * (pred - y))
        getattr(P.optimizer, opt)(0.05).minimize(loss)
    return main, startup, loss


def _transpiled(t, program, feed, port):
    servers = [PsServer("127.0.0.1:0", []).start() for _ in range(2)]
    eps = [f"127.0.0.1:{s.port}" for s in servers]
    t.transpile(0, program=program, pservers=",".join(eps), trainers=1)
    assert {ep for ep, _ in t._placement.values()} == set(eps)
    for s, ep in zip(servers, eps):
        cfgs = t.get_pserver_program(ep)
        assert cfgs, ep
        s.add_tables(cfgs)
    trainer = t.get_trainer_program(device="cpu") if port else \
        t.get_trainer_program()
    for i, ep in enumerate(eps):
        for tid, init in t.get_startup_program(ep).items():
            trainer.client.set_dense(tid, init, server=i)
    try:
        return [float(trainer.run(feed)) for _ in range(4)]
    finally:
        trainer.close()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_transpiled_trajectory_matches_jax(opt):
    rs = np.random.RandomState(0)
    feed = {"x": rs.standard_normal((8, 4)).astype("float32"),
            "y": rs.standard_normal((8, 1)).astype("float32")}
    with static_both():
        jm, js, jl = _program(J, jst, opt)
        tm, ts, tl = _program(T, tst, opt)
        copy_scope(jm, tm)
        te = port_exe()
        local = [float(te.run(tm, feed=feed, fetch_list=[tl])[0])
                 for _ in range(4)]
        copy_scope(jm, tm)   # the local run moved the port's scope
        jd = _transpiled(JTranspiler(), jm, feed, port=False)
        td = _transpiled(DistributeTranspiler(), tm, feed, port=True)
    np.testing.assert_allclose(td, jd, **TOL)
    np.testing.assert_allclose(td, local, **TOL)
    assert td[-1] < td[0]


def test_fetch_list_and_unsupported_rule():
    with static_both():
        jm, _, _ = _program(J, jst, "SGD")
        tm, _, tl = _program(T, tst, "Momentum")
        copy_scope(jm, tm)
        t = DistributeTranspiler().transpile(
            0, program=tm, pservers="127.0.0.1:1,127.0.0.1:2")
        with pytest.raises(ValueError, match="sgd/adam"):
            t.get_pserver_program("127.0.0.1:1")
        with pytest.raises(ValueError, match="pserver"):
            DistributeTranspiler().transpile(0, program=tm, pservers="")
