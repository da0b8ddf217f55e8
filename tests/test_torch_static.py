"""Static graph mode of the port (`paddle_tpu_torch.static`) against the
JAX package's (`paddle_tpu.static`): the same Programs built in both
from numpy-seeded inputs, the JAX Program's weights carried into the
port's scope, run through both Executors on the CPU.

Tolerances: fp32 values 1e-5 x max(1, max |ref|) (summation order); the
30-step MLP's losses 1e-5 relative; control flow exact."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.framework.errors import UnavailableError

from torch_static_parity import (close, copy_scope, on_the_cpu,  # noqa: F401
                                 port_exe, static_both,
                                 unique_jax_param_names)


def _mlp(P, st):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [None, 8], "float32")
        y = st.data("y", [None, 1], "float32")
        h = st.nn.fc(x, 16, activation="relu")
        pred = st.nn.fc(h, 1)
        loss = P.mean((pred - y) ** 2)
        P.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def test_mlp_training_matches_jax():
    """`tests/test_static_and_extensions.py:11`'s program: 30 Adam steps
    through both Executors from the same weights; losses to 1e-5
    relative."""
    rng = np.random.RandomState(0)
    xv = rng.rand(32, 8).astype("float32")
    yv = (xv.sum(1, keepdims=True) / 4).astype("float32")
    with static_both():
        jm, js, jl = _mlp(J, jst)
        tm, ts, tl = _mlp(T, tst)
        copy_scope(jm, tm)
        je, te = jst.Executor(), port_exe()
        je.run(js)
        te.run(ts)
        jls, tls = [], []
        for _ in range(30):
            jls.append(float(je.run(jm, feed={"x": xv, "y": yv},
                                    fetch_list=[jl])[0]))
            tls.append(float(te.run(tm, feed={"x": xv, "y": yv},
                                    fetch_list=[tl])[0]))
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    assert tls[-1] < tls[0] * 0.5, tls[::10]


@pytest.mark.parametrize("opt", ["SGD", "Adam", "AdamW"])
def test_minimize_dygraph_matches_backward_step(opt):
    """One `minimize(loss)` gives the parameters of `loss.backward();
    step()` in the port, and the JAX package's `minimize` (exact within
    a package, 1e-6 across)."""
    rng = np.random.RandomState(1)
    w = rng.standard_normal((5, 3)).astype("float32")
    b = rng.standard_normal((3,)).astype("float32")
    xv = rng.standard_normal((4, 5)).astype("float32")

    def run(P, use_minimize):
        lin = P.nn.Linear(5, 3)
        if P is T:
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(w.T))
                lin.bias.copy_(torch.from_numpy(b))
        else:
            lin.weight.set_value(w)
            lin.bias.set_value(b)
        o = getattr(P.optimizer, opt)(0.1, parameters=lin.parameters())
        loss = (lin(P.to_tensor(xv)) ** 2).mean()
        if use_minimize:
            assert o.minimize(loss) == ([], [])
        else:
            loss.backward()
            o.step()
        wv = lin.weight.detach().numpy().T if P is T else \
            np.asarray(lin.weight.numpy())
        return wv, np.asarray(lin.bias.detach().numpy() if P is T
                              else lin.bias.numpy())

    tw, tb = run(T, True)
    tw2, tb2 = run(T, False)
    jw, jb = run(J, True)
    np.testing.assert_array_equal(tw, tw2)
    np.testing.assert_array_equal(tb, tb2)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-6)


def test_minimize_static_registers_the_optimizer():
    """In static mode `minimize` marks the loss and registers the
    optimizer on the default main program, as the JAX package's."""
    with static_both():
        for P, st in ((J, jst), (T, tst)):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                x = st.data("x", [2, 3], "float32")
                loss = P.mean(st.nn.fc(x, 1))
                opt = P.optimizer.SGD(0.1)
                ops, pg = opt.minimize(loss)
            assert ops == [] and main._loss_slot == loss.slot
            assert main._opt_hooks == [opt]
            assert len(pg) == len(main.param_vars) == 2


def _ernie(P, st, net, B, S):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("input_ids", [B, S], "int64")
        m = st.data("attention_mask", [B, S], "int64")
        y = st.data("labels", [B], "int64")
        logits = net(x, attention_mask=m)
        loss = P.nn.CrossEntropyLoss()(logits, y)
        P.optimizer.AdamW(1e-3).minimize(loss)
    return main, logits, loss


NAMED = ("linear", "sdpa", "layer_norm", "embedding", "cross_entropy",
         "dropout", "gelu", "softmax", "tanh")


def test_ernie_program_matches_jax():
    """A 2-layer hidden-64 ERNIE at [4, 16] with a padded mask and
    FLAGS_flash_attention_min_seq 0 (the flash gates of both packages
    still refuse S 16, not a multiple of 128, so both run the plain
    attention; the recorded flash path is held by
    test_sdpa_mask_is_an_input_of_the_recorded_op and the serde tests):
    the named ops appear in both Programs in the same order and counts;
    Executor logits and 3 AdamW steps' losses match to 1e-5 x max(1,
    |x|)."""
    from paddle_tpu_torch.models import load_reference_state
    B, S = 4, 16

    def cfg(P):
        c = P.models.ErnieConfig.tiny()
        c.hidden_size, c.num_hidden_layers = 64, 2
        c.num_attention_heads, c.intermediate_size = 2, 128
        c.hidden_dropout_prob = c.attention_probs_dropout_prob = 0.0
        return c
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 1000, (B, S)).astype("int64")
    mask = np.ones((B, S), "int64")
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    labels = rng.randint(0, 2, (B,)).astype("int64")
    feed = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    J.set_flags({"FLAGS_flash_attention_min_seq": 0})
    T.set_flags({"FLAGS_flash_attention_min_seq": 0})
    try:
        jnet = J.models.ErnieForSequenceClassification(cfg(J), num_classes=2)
        tnet = T.models.ErnieForSequenceClassification(cfg(T), num_classes=2,
                                                       device="cpu")
        load_reference_state(tnet, {k: np.asarray(v._value) for k, v in
                                    jnet.state_dict().items()})
        unique_jax_param_names(jnet)
        with static_both():
            jm, jlog, jloss = _ernie(J, jst, jnet, B, S)
            tm, tlog, tloss = _ernie(T, tst, tnet, B, S)
            jn = [o.name for o in jm.ops if o.name in NAMED]
            tn = [o.name for o in tm.ops if o.name in NAMED]
            assert tn == jn and tn.count("sdpa") == 2, (tn, jn)
            je, te = jst.Executor(), port_exe()
            for _ in range(3):
                a = je.run(jm, feed=feed, fetch_list=[jloss, jlog])
                b = te.run(tm, feed=feed, fetch_list=[tloss, tlog])
                close(b[0], a[0], 1e-5)
                close(b[1], a[1], 1e-5)
    finally:
        J.set_flags({"FLAGS_flash_attention_min_seq": 512})
        T.set_flags({"FLAGS_flash_attention_min_seq": 512})


def _with_dead_branch(P, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [4, 8], "float32")
        out = st.nn.fc(st.nn.fc(x, 16, activation="relu"), 2)
        dead = P.nn.functional.relu(st.nn.fc(x, 8))
    return main, out, dead


def test_prune_matches_jax():
    """Program.prune keeps only what the targets need (reference
    framework/prune.cc): the same op names survive in both packages and
    the pruned Program computes the same output."""
    xv = np.random.RandomState(3).standard_normal((4, 8)).astype("float32")
    with static_both():
        jm, jout, _ = _with_dead_branch(J, jst)
        tm, tout, _ = _with_dead_branch(T, tst)
        copy_scope(jm, tm)
        jp, tp = jm.prune([jout]), tm.prune([tout])
        assert [o.name for o in tp.ops] == [o.name for o in jp.ops]
        assert len(tp.ops) < len(tm.ops) and len(tp.param_vars) == 4
        assert list(tp.feed_vars) == ["x"]
        a = jst.Executor().run(jp, feed={"x": xv}, fetch_list=[jout])[0]
        b = port_exe().run(tp, feed={"x": xv}, fetch_list=[tout])[0]
        c = port_exe().run(tm, feed={"x": xv}, fetch_list=[tout])[0]
    close(b, a, 1e-5)
    np.testing.assert_array_equal(b, c)


def test_device_guard_records_attr():
    with static_both():
        for P, st in ((J, jst), (T, tst)):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                x = st.data("x", [2, 2], "float32")
                with st.device_guard("cpu"):
                    y = P.nn.functional.relu(x)
                assert main.ops[-1].attrs.get("op_device") == "cpu"
                P.nn.functional.relu(y)
                assert "op_device" not in (main.ops[-1].attrs or {})


def _cond_prog(P, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [4], "float32")
        out = st.nn.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)
    return main, out


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_records_sub_blocks(sign):
    """`cond` on a Variable records one `cond` op with two sub-blocks
    (`tests/test_block_ir.py:16`) and replays the branch the feed
    takes, in both packages."""
    xv = sign * np.arange(1, 5, dtype="float32")
    with static_both():
        outs = []
        for P, st, exe in ((J, jst, jst.Executor()),
                           (T, tst, port_exe())):
            main, out = _cond_prog(P, st)
            assert main.num_blocks == 3
            op = main.ops[-1]
            assert op.type == "cond"
            tb, fb = op.attr("sub_block"), op.attr("sub_block_false")
            assert {tb, fb} == {1, 2}
            assert main.block(tb).ops and main.block(fb).ops
            assert main.block(tb).parent_idx == 0
            outs.append(exe.run(main, feed={"x": xv}, fetch_list=[out])[0])
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], xv * 2 if sign > 0 else xv - 1)


def _while_prog(P, st, nested):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [1], "float32")
        i0 = P.zeros([1], "int32")
        if nested:
            _, st_n = st.nn.while_loop(
                lambda i, s: (i < 3).all(),
                lambda i, s: (i + 1, {"s": s["s"] + x}),
                (i0, {"s": P.zeros([1], "float32")}))
            out = st_n["s"]
        else:
            _, out = st.nn.while_loop(
                lambda i, s: (i < 3).all(), lambda i, s: (i + 1, s + x),
                (i0, P.zeros([1], "float32")))
    return main, out


@pytest.mark.parametrize("nested", [False, True])
def test_static_while_is_feed_dependent(nested):
    """One `while` op with its sub-block; the replay follows the feed
    (`tests/test_block_ir.py:46,160`), in both packages."""
    with static_both():
        for P, st, exe in ((J, jst, jst.Executor()),
                           (T, tst, port_exe())):
            main, out = _while_prog(P, st, nested)
            wop = [op for op in main.ops if op.type == "while"]
            assert len(wop) == 1 and wop[0].has_attr("sub_block")
            assert main.block(wop[0].attr("sub_block")).ops
            for v in (2.0, 5.0):
                got = exe.run(main, feed={"x": np.asarray([v], "float32")},
                              fetch_list=[out])[0]
                assert float(got[0]) == 3 * v


def test_switch_case_and_case_both_modes():
    """switch_case records one op with a sub-block a branch in static
    mode; case runs Python (as the JAX package's); both in dygraph."""
    with static_both():
        outs = []
        for P, st, exe in ((J, jst, jst.Executor()),
                           (T, tst, port_exe())):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                k = st.data("k", [], "int32")
                x = st.data("x", [3], "float32")
                out = st.nn.switch_case(k, [lambda: x + 1.0,
                                            lambda: x * 3.0,
                                            lambda: x - 7.0])
            sw = [op for op in main.ops if op.type == "switch_case"]
            assert len(sw) == 1 and main.num_blocks == 4
            xv = np.asarray([1.0, 2.0, 3.0], "float32")
            outs.append([exe.run(main, feed={"k": np.asarray(i, "int32"),
                                             "x": xv}, fetch_list=[out])[0]
                         for i in range(3)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    for P, st in ((J, jst), (T, tst)):
        x = P.to_tensor(np.asarray(2.0, "float32"))
        assert float(st.nn.switch_case(P.to_tensor(np.asarray(1)),
                                       {0: lambda: x, 1: lambda: x * 5})) \
            == 10.0
        assert float(st.nn.case([(x > 5, lambda: x), (x > 1, lambda: x * 2)],
                                default=lambda: x * 0)) == 4.0
        assert float(st.nn.case([(x > 5, lambda: x)],
                                default=lambda: x * 0)) == 0.0


def test_dygraph_control_flow_unchanged():
    for P, st in ((J, jst), (T, tst)):
        x = P.to_tensor(np.asarray(3.0, "float32"))
        out = st.nn.cond(x > 2, lambda: x * 2, lambda: x - 1)
        assert float(out) == 6.0
        i2, s2 = st.nn.while_loop(
            lambda i, s: i < 5, lambda i, s: (i + 1, s + 2.0),
            (P.to_tensor(np.asarray(0)),
             P.to_tensor(np.asarray(0.0, "float32"))))
        assert int(i2) == 5 and float(s2) == 10.0


def test_branch_captured_parameters_stay_live():
    """`tests/test_block_ir.py:126`: a layer's weights used inside a
    branch are inputs of the cond op, so scope updates reach it."""
    with static_both():
        main = tst.Program()
        with tst.program_guard(main, tst.Program()):
            lin = T.nn.Linear(2, 2)
            x = tst.data("x", [1, 2], "float32")
            out = tst.nn.cond(x.sum() > -1e9, lambda: lin(x), lambda: x)
        cop = main.ops[-1]
        param_slots = {p.slot for p in main.all_parameters()}
        assert param_slots & set(cop.input_slots)
        exe = port_exe()
        xv = np.ones((1, 2), "float32")
        before = exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
        scope = tst.global_scope()
        for n in main.param_vars:
            scope[n] = scope[n] * 0.0 + (7.0 if scope[n].dim() == 1
                                         else 0.0)
        after = exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
    np.testing.assert_allclose(after, np.full((1, 2), 7.0))
    assert not np.allclose(before, after)


def test_prune_keeps_sub_block_attrs_resolvable():
    with static_both():
        main, out = _cond_prog(T, tst)
        pruned = main.prune([out])
        cop = [op for op in pruned.ops if op.type == "cond"][0]
        assert pruned.block(cop.attr("sub_block")).ops
        assert pruned.num_blocks == main.num_blocks


def test_block_var_lookup_and_operator_surface():
    with static_both():
        for st in (jst, tst):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                x = st.data("x", [2, 3], "float32")
                y = x * 3.0
            blk = main.global_block()
            assert blk.idx == 0 and blk.parent_block is None
            assert blk.var("x") is x
            op = main.ops[-1]
            assert op.type == "multiply" and op.out_slots == [y.slot]
            assert x.slot in op.input_slots
            assert isinstance(op.all_attrs(), dict)


def test_top_level_mode_names():
    for P in (J, T):
        assert P.in_dynamic_mode() and P.in_dygraph_mode()
        P.enable_static()
        assert not P.in_dynamic_mode() and not P.in_dygraph_mode()
        P.enable_dygraph()
        assert P.in_dynamic_mode()
        P.disable_dygraph()
        assert not P.in_dygraph_mode()
        P.disable_static()
        assert P.in_dynamic_mode()
        P.enable_static()
        try:
            v = P.data("d", [None, 3], "float32")
            assert tuple(v.shape) == (1, 3)
        finally:
            P.disable_static()


def test_train_from_dataset_takes_any_iterable():
    """Executor.train_from_dataset over a generator of batches (in
    sorted feed-name order) trains as run() does."""
    rng = np.random.RandomState(5)
    batches = [(rng.rand(8, 8).astype("float32"),
                rng.rand(8, 1).astype("float32")) for _ in range(4)]
    with static_both():
        main, startup, loss = _mlp(T, tst)
        exe = port_exe()
        res = exe.train_from_dataset(main, (b for b in batches),
                                     fetch_list=[loss])
        assert len(res) == 4 and main._step_no == 4
        assert exe.infer_from_dataset(main, iter([]), fetch_list=[loss]) \
            == []


def test_startup_program_runs_only_its_own_ops():
    with static_both():
        main, startup = tst.Program(), tst.Program()
        assert port_exe().run(startup) == []
        with tst.program_guard(startup, tst.Program()):
            x = tst.data("x", [2], "float32")
            x + 1.0
        assert len(startup.ops) == 1
        assert port_exe().run(startup) == []


def test_entry_points_take_the_card_by_default():
    """Executor() and load_inference_model run on the card unless asked
    for the CPU; with no card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UnavailableError):
        tst.Executor(T.CUDAPlace(0))
    T.set_device("gpu")
    with pytest.raises(UnavailableError):
        tst.Executor()
    with pytest.raises(UnavailableError):
        tst.load_inference_model("/nonexistent/model")


# -- static.nn: every wrapper against the JAX package's -------------------------

def _x(shape, seed=0, dtype="float32"):
    rng = np.random.RandomState(seed)
    if dtype == "int64":
        return rng.randint(0, 10, shape).astype("int64")
    return rng.standard_normal(shape).astype(dtype)


# name -> (build(P, st, *vars) -> outputs, [(feed name, shape, dtype)])
NN_CASES = {
    "fc": (lambda P, s, x: s.nn.fc(x, 6, activation="relu"),
           [("x", [4, 5], "float32")]),
    "fc_flatten": (lambda P, s, x: s.nn.fc(x, 3, num_flatten_dims=2),
                   [("x", [2, 3, 4], "float32")]),
    "conv2d": (lambda P, s, x: s.nn.conv2d(x, 4, 3, padding=1, act="relu"),
               [("x", [2, 3, 6, 6], "float32")]),
    "conv3d": (lambda P, s, x: s.nn.conv3d(x, 2, 3, padding=1),
               [("x", [1, 2, 4, 4, 4], "float32")]),
    "conv2d_transpose": (lambda P, s, x: s.nn.conv2d_transpose(
        x, 3, filter_size=3, stride=2), [("x", [1, 2, 4, 4], "float32")]),
    "batch_norm": (lambda P, s, x: s.nn.batch_norm(x),
                   [("x", [4, 3, 5, 5], "float32")]),
    "layer_norm": (lambda P, s, x: s.nn.layer_norm(x, begin_norm_axis=1),
                   [("x", [4, 6], "float32")]),
    "embedding": (lambda P, s, x: s.nn.embedding(x, [10, 6]),
                  [("x", [3, 4], "int64")]),
    "dropout_test": (lambda P, s, x: s.nn.dropout(x, 0.5, is_test=True),
                     [("x", [4, 6], "float32")]),
    "pool2d_max": (lambda P, s, x: s.nn.pool2d(x, 2, "max", 2),
                   [("x", [1, 2, 6, 6], "float32")]),
    "pool2d_global_avg": (lambda P, s, x: s.nn.pool2d(
        x, pool_type="avg", global_pooling=True),
        [("x", [1, 2, 6, 6], "float32")]),
    "relu_softmax": (lambda P, s, x: s.nn.softmax(s.nn.relu(x)),
                     [("x", [3, 5], "float32")]),
    "reduce": (lambda P, s, x: (s.nn.reduce_sum(x, dim=1),
                                s.nn.reduce_mean(x, dim=0, keep_dim=True),
                                s.nn.mean(x)),
               [("x", [3, 5], "float32")]),
    "mul_concat": (lambda P, s, x, y: s.nn.concat(
        [s.nn.mul(x, y), s.nn.mul(x, y)], axis=1),
        [("x", [2, 3, 4], "float32"), ("y", [12, 5], "float32")]),
    "accuracy_topk": (lambda P, s, x, y: (s.nn.accuracy(x, y, k=2),
                                          s.nn.topk(x, 2)[0]),
                      [("x", [6, 5], "float32"), ("y", [6, 1], "int64")]),
    "one_hot_l2": (lambda P, s, x, y: (s.nn.one_hot(y, 10),
                                       s.nn.l2_normalize(x, axis=1)),
                   [("x", [6, 5], "float32"), ("y", [6], "int64")]),
    "sigmoid_ce": (lambda P, s, x, y: s.nn.sigmoid_cross_entropy_with_logits(
        x, y, ignore_index=-1, normalize=True),
        [("x", [4, 3], "float32"), ("y", [4, 3], "float32")]),
    "cross_entropy_probs": (lambda P, s, x, y: s.nn.cross_entropy(
        s.nn.softmax(x), y), [("x", [4, 5], "float32"), ("y", [4, 1],
                                                         "int64")]),
    "lstm_unit": (lambda P, s, x, h, c: s.nn.lstm_unit(x, h, c, 0.5),
                  [("x", [2, 3], "float32"), ("h", [2, 4], "float32"),
                   ("c", [2, 4], "float32")]),
    "gru_unit": (lambda P, s, x, h: s.nn.gru_unit(x, h, 12),
                 [("x", [2, 12], "float32"), ("h", [2, 4], "float32")]),
}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_static_nn_matches_jax(case):
    build, feeds = NN_CASES[case]
    vals = {}
    for i, (n, shape, dt) in enumerate(feeds):
        v = _x(shape, seed=i, dtype=dt)
        if case == "sigmoid_ce" and n == "y":
            v = (v > 0).astype("float32")
            v[0, 0] = -1.0
        if case in ("accuracy_topk", "one_hot_l2", "cross_entropy_probs") \
                and n == "y":
            v = v % 5
        vals[n] = v
    outs = []
    with static_both():
        progs = []
        for P, st in ((J, jst), (T, tst)):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                vs = [st.data(n, shape, dt) for n, shape, dt in feeds]
                out = build(P, st, *vs)
            progs.append((main, out if isinstance(out, (tuple, list))
                          else [out]))
        (jm, jo), (tm, to) = progs
        copy_scope(jm, tm)
        outs = [jst.Executor().run(jm, feed=vals, fetch_list=list(jo)),
                port_exe().run(tm, feed=vals, fetch_list=list(to))]
    for a, b in zip(*outs):
        close(b, a, 1e-5)


@pytest.mark.chip
def test_static_ernie_step_on_the_card():
    """A tiny ERNIE Program trained one Executor step on the card: its
    two sdpa ops launch K2, K3 and K4 twice each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only on "
                    "the card")
    from paddle_tpu_torch.ops import flash_ops
    c = T.models.ErnieConfig.tiny()
    c.num_hidden_layers = 2
    net = T.models.ErnieForSequenceClassification(c, device="cuda")
    T.set_device("gpu")
    T.set_flags({"FLAGS_flash_attention_min_seq": 0})
    try:
        with static_both():
            main, _, loss = _ernie(T, tst, net, 2, 64)
        w = (flash_ops.flash_attention_fwd, flash_ops.flash_attention_dq,
             flash_ops.flash_attention_dkv)
        before = [f.launches for f in w]
        tst.Executor().run(main, feed={
            "input_ids": _x([2, 64], dtype="int64"),
            "attention_mask": np.ones((2, 64), "int64"),
            "labels": np.zeros(2, "int64")}, fetch_list=[loss])
        assert [f.launches - b for f, b in zip(w, before)] == [2, 2, 2]
    finally:
        T.set_flags({"FLAGS_flash_attention_min_seq": 512})


def test_a_layer_recorded_into_two_programs():
    """A layer read by a second Program is registered in it too (ROADMAP
    C31: the JAX package promotes a parameter only once, so its second
    Program has no parameters and its Executor raises KeyError)."""
    xv = np.ones((2, 3), "float32")
    with static_both():
        lin = J.nn.Linear(3, 2)
        for k in range(2):
            main = jst.Program()
            with jst.program_guard(main, jst.Program()):
                x = jst.data("x", [2, 3], "float32")
                y = lin(x)
            if k:
                assert len(main.param_vars) == 0
                with pytest.raises(KeyError):
                    jst.Executor().run(main, feed={"x": xv}, fetch_list=[y])
        lin = T.nn.Linear(3, 2)
        outs = []
        for _ in range(2):
            main = tst.Program()
            with tst.program_guard(main, tst.Program()):
                x = tst.data("x", [2, 3], "float32")
                y = lin(x)
            assert len(main.param_vars) == 2
            outs.append(port_exe().run(main, feed={"x": xv},
                                       fetch_list=[y])[0])
    np.testing.assert_array_equal(outs[1], outs[0])


def test_sdpa_mask_is_an_input_of_the_recorded_op():
    """The recorded `sdpa` op takes its key-padding mask as an input, so
    a fed mask reaches the flash path (ROADMAP C30: the JAX package's
    flash op closes over the mask it was built with). Each fed mask
    gives dygraph's output for it."""
    T.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        rng = np.random.RandomState(6)
        q = rng.standard_normal((2, 2, 128, 32)).astype("float32")
        with static_both():
            main = tst.Program()
            with tst.program_guard(main, tst.Program()):
                qv = tst.data("q", [2, 2, 128, 32], "float32")
                m = tst.data("m", [2, 1, 1, 128], "float32")
                o = T.nn.functional.scaled_dot_product_attention(
                    qv, qv, qv, attn_mask=m)
            op = [op for op in main.ops if op.name == "sdpa"][0]
            assert m.slot in op.input_slots
            outs = []
            for cut in (128, 40):
                mv = np.zeros((2, 1, 1, 128), "float32")
                mv[1, ..., cut:] = -1e4
                got = port_exe().run(main, feed={"q": q, "m": mv},
                                     fetch_list=[o])[0]
                t = torch.from_numpy(q)
                want = T.nn.functional.scaled_dot_product_attention(
                    t, t, t, attn_mask=torch.from_numpy(mv)).numpy()
                np.testing.assert_array_equal(got, want)
                outs.append(got)
        assert not np.allclose(outs[0][1], outs[1][1])
    finally:
        T.set_flags({"FLAGS_flash_attention_min_seq": 512})
