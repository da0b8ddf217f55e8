"""paddle.static.amp of the port against the JAX package's (reference
`fluid/contrib/mixed_precision/`: decorate + rewrite_program + the fp16
lists; `tests/test_static_amp.py`).

Tolerances: a rewritten Program against the JAX package's rewritten one
on the same weights 2e-2 x max(1, max |ref|) (one bf16 rounding of each
white op's inputs, which the two libraries' GEMMs round and accumulate
their own way); against its own fp32 run the same, and not equal."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu_torch import static as tst

from torch_static_parity import (close, copy_scope, on_the_cpu,  # noqa: F401
                                 port_exe, static_both)


def _mlp_softmax(P, st):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [4, 8], "float32")
        h = st.nn.fc(x, 8, activation="relu")
        out = st.nn.softmax(h)
    return main, startup, out


def test_rewrite_program_matches_jax_within_bf16():
    feed = {"x": np.random.RandomState(1).rand(4, 8).astype("float32")}
    with static_both():
        jm, _, jo = _mlp_softmax(J, jst)
        tm, _, to = _mlp_softmax(T, tst)
        copy_scope(jm, tm)
        je, te = jst.Executor(), port_exe()
        ref32 = te.run(tm, feed=feed, fetch_list=[to])[0]
        jst.amp.rewrite_program(jm)
        tst.amp.rewrite_program(tm)
        assert [(o.name, o.attrs.get("amp_dtype")) for o in tm.ops] == \
            [(o.name, o.attrs.get("amp_dtype")) for o in jm.ops]
        want = je.run(jm, feed=feed, fetch_list=[jo])[0]
        got = te.run(tm, feed=feed, fetch_list=[to])[0]
    close(got, want, 2e-2)
    close(got, ref32, 2e-2)
    assert not np.array_equal(got, ref32)   # the bf16 rounding shows


@pytest.mark.parametrize("white,black", [(["matmul"], []),
                                         ([], ["linear", "relu"]),
                                         (["softmax"], ["matmul"])])
def test_custom_lists_match_jax(white, black):
    a = jst.amp.CustomOpLists(custom_white_list=white,
                              custom_black_list=black)
    b = tst.amp.AutoMixedPrecisionLists(custom_white_list=white,
                                        custom_black_list=black)
    assert b.white_list == a.white_list and b.black_list == a.black_list
    for n in black:
        assert n in b.black_list and n not in b.white_list
    with pytest.raises(ValueError):
        tst.amp.CustomOpLists(custom_white_list=["x"],
                              custom_black_list=["x"])


def _train(P, st, steps, xv, yv, lists=None):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [16, 8], "float32")
        y = st.data("y", [16, 1], "float32")
        h = st.nn.fc(x, 32, activation="relu")
        pred = st.nn.fc(h, 1)
        loss = ((pred - y) * (pred - y)).mean()
        opt = st.amp.decorate(P.optimizer.SGD(0.05), amp_lists=lists)
        opt.minimize(loss)
    return main, startup, loss


def test_decorate_rewrites_and_trains_as_jax():
    """decorate + minimize: the same ops get the same amp_dtype in both
    packages; 40 SGD steps from the same weights fall below half the
    first loss in both, and the port's losses track the JAX package's
    within bf16 rounding (2e-2 x max(1, loss))."""
    rng = np.random.RandomState(0)
    xv = rng.rand(16, 8).astype("float32")
    yv = (xv.sum(1, keepdims=True) / 4).astype("float32")
    feed = {"x": xv, "y": yv}
    with static_both():
        jm, js, jl = _train(J, jst, 40, xv, yv)
        tm, ts, tl = _train(T, tst, 40, xv, yv)
        assert [(o.name, o.attrs.get("amp_dtype")) for o in tm.ops] == \
            [(o.name, o.attrs.get("amp_dtype")) for o in jm.ops]
        assert any(o.attrs.get("amp_dtype") == "bfloat16" for o in tm.ops)
        copy_scope(jm, tm)
        je, te = jst.Executor(), port_exe()
        je.run(js)
        te.run(ts)
        jls, tls = [], []
        for _ in range(40):
            jls.append(float(je.run(jm, feed=feed, fetch_list=[jl])[0]))
            tls.append(float(te.run(tm, feed=feed, fetch_list=[tl])[0]))
    assert tls[-1] < tls[0] * 0.5 and jls[-1] < jls[0] * 0.5
    close(tls[:5], jls[:5], 2e-2)


def test_decorate_with_custom_black_list_keeps_linear_fp32():
    rng = np.random.RandomState(2)
    xv = rng.rand(16, 8).astype("float32")
    yv = xv[:, :1]
    with static_both():
        tm, _, tl = _train(T, tst, 1, xv, yv,
                           lists=tst.amp.CustomOpLists(
                               custom_black_list=["linear"]))
        assert {o.attrs.get("amp_dtype") for o in tm.ops
                if o.name == "linear"} == {"float32"}
        lv = port_exe().run(tm, feed={"x": xv, "y": yv},
                            fetch_list=[tl])[0]
    assert np.isfinite(lv)
