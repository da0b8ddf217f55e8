"""The op-level Program document of the port (`static.serde`: JSON, each
op a `torch.export` program), the passes (`static.passes`) and
save / load_inference_model, against the JAX package's
(`tests/test_program_serde.py`, `tests/test_block_ir.py:93`).

Tolerances: a reloaded Program replays its ops' exported programs on the
same inputs, so outputs are exact in process and across processes;
against the JAX package 1e-5 x max(1, max |ref|) (summation order);
gradients of a loaded Program against the built one's exact."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.framework.errors import NotFoundError
from paddle_tpu_torch.static.program import make_parameter

from torch_static_parity import (close, copy_scope, on_the_cpu,  # noqa: F401
                                 port_exe, static_both)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def static_mode():
    T.enable_static()
    main = tst.Program()
    with tst.program_guard(main, tst.Program()), tst.scope_guard({}):
        yield main
    T.disable_static()


def _w(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype("float32"))


def _build_mlp():
    x = tst.data("x", [4, 8], "float32")
    w1 = make_parameter("w1", _w(0, 8, 16))
    b1 = make_parameter("b1", _w(1, 16))
    w2 = make_parameter("w2", _w(2, 16, 2))
    h = T.nn.functional.relu(T.matmul(x, w1) + b1)
    return x, T.matmul(h, w2)


def _feed(seed):
    return np.random.RandomState(seed).standard_normal((4, 8)).astype(
        "float32")


def test_roundtrip_in_process(static_mode, tmp_path):
    main = static_mode
    x, out = _build_mlp()
    feed = {"x": _feed(0)}
    ref = port_exe().run(main, feed=feed, fetch_list=[out])[0]
    path = str(tmp_path / "prog.ptprog")
    main.save(path)
    prog2, params = tst.load_program(path, "cpu")
    assert set(params) == {"w1", "b1", "w2"}
    types = [op.name for op in prog2.ops]
    assert "matmul" in types and "relu" in types
    with tst.scope_guard(dict(params)):
        got = port_exe().run(prog2, feed=feed,
                             fetch_list=[prog2.vars[out.slot]])[0]
    np.testing.assert_array_equal(got, ref)


def test_roundtrip_matches_jax(tmp_path):
    """The same MLP in both packages (fc layers, weights carried): the
    port's reloaded Program computes the JAX package's built one's."""
    feed = {"x": _feed(1)}
    with static_both():
        progs = []
        for P, st in ((J, jst), (T, tst)):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                x = st.data("x", [4, 8], "float32")
                out = st.nn.fc(st.nn.fc(x, 16, activation="relu"), 2)
            progs.append((main, out))
        (jm, jo), (tm, to) = progs
        copy_scope(jm, tm)
        ref = jst.Executor().run(jm, feed=feed, fetch_list=[jo])[0]
        tm.save(str(tmp_path / "p.ptprog"))
        prog2, params = tst.load_program(str(tmp_path / "p.ptprog"), "cpu")
        with tst.scope_guard(dict(params)):
            got = port_exe().run(prog2, feed=feed,
                                 fetch_list=[prog2.vars[to.slot]])[0]
    close(got, ref, 1e-5)


def test_doc_is_json_and_inspectable(static_mode, tmp_path):
    _build_mlp()
    path = str(tmp_path / "prog.ptprog")
    static_mode.save(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 1
    assert {"ops", "vars", "feed_vars", "param_vars"} <= set(doc)
    op0 = doc["ops"][0]
    assert {"type", "attrs", "inputs", "outputs", "export_b64"} <= set(op0)
    assert doc["vars"][str(doc["feed_vars"]["x"])]["shape"] == [4, 8]


def test_loaded_program_is_differentiable(static_mode, tmp_path):
    """A loaded Program trains: its first SGD update equals the built
    Program's exactly, and five steps lower the loss."""
    main = static_mode
    x, out = _build_mlp()
    loss = T.mean(out * out)
    main._loss_slot = loss.slot
    path = str(tmp_path / "prog.ptprog")
    main.save(path)
    feed = {"x": _feed(2)}
    built = {n: v.clone() for n, v in tst.global_scope().items()}
    main._opt_hooks.append(T.optimizer.SGD(0.1))
    with tst.scope_guard(built):
        port_exe().run(main, feed=feed, fetch_list=[loss])
    prog2, params = tst.load_program(path, "cpu")
    scope = dict(params)
    with tst.scope_guard(scope):
        prog2._opt_hooks.append(T.optimizer.SGD(0.1))
        lv = prog2.vars[prog2._loss_slot]
        exe = port_exe()
        l0 = exe.run(prog2, feed=feed, fetch_list=[lv])[0]
        for n in scope:
            torch.testing.assert_close(scope[n], built[n], rtol=0, atol=0)
        for _ in range(5):
            ln = exe.run(prog2, feed=feed, fetch_list=[lv])[0]
    assert float(ln) < float(l0)


def test_loaded_flash_program_trains_through_the_op(tmp_path):
    """A loaded program's `sdpa` is a `paddle_tpu_torch::flash_fwd` node:
    its registered autograd formula differentiates it (K3/K4's plain
    versions here), giving the built Program's gradients."""
    from paddle_tpu_torch.ops import flash_ops
    T.set_flags({"FLAGS_flash_attention_min_seq": 0})
    try:
        T.enable_static()
        main = tst.Program()
        with tst.program_guard(main, tst.Program()), tst.scope_guard({}):
            q = tst.data("q", [1, 2, 128, 32], "float32")
            w = make_parameter("w", _w(3, 32, 32))
            h = T.matmul(q, w)
            o = T.nn.functional.scaled_dot_product_attention(h, h, h)
            loss = (o * o).mean()
            main._loss_slot = loss.slot
            assert [op.name for op in main.ops].count("sdpa") == 1
            main.save(str(tmp_path / "f.ptprog"))
            scope0 = {n: v.clone() for n, v in tst.global_scope().items()}
        T.disable_static()
        feed = {"q": np.random.RandomState(4).standard_normal(
            (1, 2, 128, 32)).astype("float32")}
        results = []
        for prog, scope in ((main, dict(scope0)),
                            tst.load_program(str(tmp_path / "f.ptprog"),
                                             "cpu")):
            scope = dict(scope)
            prog._opt_hooks = [T.optimizer.SGD(1.0)]
            calls = [0]
            ref = flash_ops._dq_reference

            def counted(*a, **k):
                calls[0] += 1
                return ref(*a, **k)
            flash_ops._dq_reference = counted
            try:
                with tst.scope_guard(scope):
                    port_exe().run(prog, feed=feed,
                                   fetch_list=[prog.vars[loss.slot]])
            finally:
                flash_ops._dq_reference = ref
            assert calls[0] == 1
            results.append(scope["w"])
        assert any(op.name == "sdpa" for op in prog.ops)
        torch.testing.assert_close(results[1], results[0], rtol=0, atol=0)
        assert not torch.equal(results[0], scope0["w"])
    finally:
        T.set_flags({"FLAGS_flash_attention_min_seq": 512})
        T.disable_static()


def test_unconsumed_feed_and_param_survive(static_mode, tmp_path):
    _build_mlp()
    tst.data("label", [4], "int64")
    make_parameter("spare", torch.zeros(3))
    path = str(tmp_path / "prog.ptprog")
    static_mode.save(path)
    prog2, params = tst.load_program(path, "cpu")
    assert "label" in prog2.feed_vars and "spare" in params


def test_loaded_program_slots_do_not_collide(static_mode, tmp_path):
    _build_mlp()
    path = str(tmp_path / "prog.ptprog")
    static_mode.save(path)
    prog2, _ = tst.load_program(path, "cpu")
    loaded_slots = set(prog2.vars)
    with tst.program_guard(prog2):
        v = tst.data("extra", [2, 2], "float32")
        w = T.nn.functional.relu(v)
    assert v.slot not in loaded_slots and w.slot not in loaded_slots
    assert repr(prog2)


def test_serde_preserves_block_structure(tmp_path):
    with static_both():
        main = tst.Program()
        with tst.program_guard(main, tst.Program()):
            x = tst.data("x", [2], "float32")
            out = tst.nn.cond(x.sum() > 0, lambda: x * 2.0, lambda: x * -1.0)
        path = str(tmp_path / "prog.json")
        main.save(path)
        loaded, _ = tst.Program.load(path)
        assert loaded.num_blocks == main.num_blocks == 3
        lop = loaded.ops[-1]
        assert lop.type == "cond"
        assert loaded.block(lop.attr("sub_block")).ops
        for v in (1.0, -1.0):
            got = port_exe().run(loaded, feed={"x": np.asarray(
                [v, v], "float32")}, fetch_list=[loaded.vars[out.slot]])[0]
            np.testing.assert_array_equal(got, [2 * v, 2 * v] if v > 0
                                          else [-v, -v])


def test_constant_folding_pass_matches_jax():
    """Const-only subgraphs fold away (reference
    framework/ir/constant_folding_pass.cc): fewer ops, the same output,
    in both packages."""
    xv = _feed(4)[:2, :3]
    outs = []
    with static_both():
        for P, st, exe in ((J, jst, jst.Executor()),
                           (T, tst, port_exe())):
            main = st.Program()
            with st.program_guard(main, st.Program()), st.scope_guard({}):
                x = st.data("x", [2, 3], "float32")
                c = P.to_tensor(np.full((2, 3), 2.0, np.float32))
                folded = P.exp(c) + P.to_tensor(np.ones((2, 3), np.float32))
                out = x * folded
                n_before = len(main.ops)
                st.PassManager(["constant_folding_pass"]).apply(main)
                assert len(main.ops) <= n_before
                outs.append(exe.run(main, feed={"x": xv},
                                    fetch_list=[out])[0])
    close(outs[1], outs[0], 1e-6)
    close(outs[1], xv * (np.exp(2.0) + 1.0), 1e-6)


def test_constant_folding_folds_recorded_constant_ops(static_mode):
    """The port's recorder keeps a computation over constants only out
    of the Program; an op recorded over constants all the same (here
    through record_op) folds into a constant of its consumer."""
    from paddle_tpu_torch.static.program import _new_var, record_op
    x = tst.data("x", [2], "float32")
    w = make_parameter("w", torch.ones(2))
    c = _new_var(torch.ones(2))
    record_op("exp", torch.exp, [torch.zeros(2)], [c])
    out = x * w + c
    n = len(static_mode.ops)
    tst.PassManager(["constant_folding_pass"]).apply(static_mode)
    assert len(static_mode.ops) < n
    got = port_exe().run(static_mode, feed={"x": np.ones(2, "float32")},
                         fetch_list=[out])[0]
    np.testing.assert_array_equal(got, [2.0, 2.0])


def test_dead_code_elimination_pass(static_mode):
    x, out = _build_mlp()
    T.nn.functional.relu(T.matmul(x, make_parameter("wdead", _w(5, 8, 8))))
    n = len(static_mode.ops)
    tst.get_pass("dead_code_elimination_pass")(static_mode, targets=[out])
    assert len(static_mode.ops) < n
    assert "wdead" not in static_mode.param_vars


def test_pass_registry_unknown_raises():
    for st in (jst, tst):
        with pytest.raises(KeyError):
            st.get_pass("nope_pass")
    with pytest.raises(NotFoundError):
        tst.get_pass("nope_pass")


def test_save_load_inference_model_and_predictor(static_mode, tmp_path):
    """save_inference_model writes a torch.export `.pdmodel` (Predictor
    runs it), the params by name and the `.ptprog`; load_inference_model
    rebuilds the Program on the executor's place."""
    from paddle_tpu_torch import inference
    x, out = _build_mlp()
    feed = {"x": _feed(6)}
    exe = port_exe()
    ref = exe.run(static_mode, feed=feed, fetch_list=[out])[0]
    prefix = str(tmp_path / "model")
    names = tst.save_inference_model(prefix, [x], [out], exe,
                                     program=static_mode)
    assert names == [out.name]
    for ext in (".pdmodel", ".pdiparams", ".ptprog"):
        assert os.path.exists(prefix + ext)
    assert set(torch.load(prefix + ".pdiparams")) == {"w1", "b1", "w2"}
    with tst.scope_guard({}):
        prog, feeds, fetches = tst.load_inference_model(prefix, exe)
        assert feeds == ["x"]
        got = exe.run(prog, feed=feed,
                      fetch_list=[prog.vars[prog._fetch_slots[0]]])[0]
    np.testing.assert_array_equal(got, ref)
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    np.testing.assert_array_equal(pred.run([feed["x"]])[0], ref)


def test_static_save_load_params(static_mode, tmp_path):
    _build_mlp()
    tst.save(static_mode, str(tmp_path / "m"))
    scope = tst.global_scope()
    before = {k: v.clone() for k, v in scope.items()}
    for k in scope:
        scope[k] = scope[k] * 0
    tst.load(static_mode, str(tmp_path / "m"), executor=port_exe())
    for k in before:
        torch.testing.assert_close(scope[k], before[k], rtol=0, atol=0)


def test_roundtrip_new_process(static_mode, tmp_path):
    """save -> a fresh interpreter (no JAX imported) -> load -> identical
    outputs (the reference's deployment contract, `fluid/io.py:1199`)."""
    x, out = _build_mlp()
    exe = port_exe()
    feed_x = _feed(7)
    ref = exe.run(static_mode, feed={"x": feed_x}, fetch_list=[out])[0]
    prefix = str(tmp_path / "model")
    tst.save_inference_model(prefix, [x], [out], exe, program=static_mode)
    np.save(str(tmp_path / "feed.npy"), feed_x)
    child = textwrap.dedent(f"""
        import sys
        import numpy as np
        import paddle_tpu_torch as T
        import paddle_tpu_torch.static as static
        prog, feeds, fetches = static.load_inference_model(
            {prefix!r}, static.Executor(T.CPUPlace()))
        assert feeds == ["x"], feeds
        out_var = prog.vars[prog._fetch_slots[0]]
        got = static.Executor(T.CPUPlace()).run(
            prog, feed={{"x": np.load({str(tmp_path / "feed.npy")!r})}},
            fetch_list=[out_var])[0]
        np.save({str(tmp_path / "out.npy")!r}, got)
        assert "jax" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", child], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")), ref)


def test_rewritten_program_roundtrips(tmp_path):
    """After static.amp's rewrite a white op's output is bf16 where it
    was recorded fp32: the document exports each op over the types it
    meets when the Program runs (`serde.propagate`; ROADMAP C33), so the
    reloaded Program computes the rewritten one's outputs exactly."""
    with static_both():
        main = tst.Program()
        with tst.program_guard(main, tst.Program()), tst.scope_guard({}):
            x = tst.data("x", [4, 8], "float32")
            h = tst.nn.fc(x, 16, activation="relu")
            out = tst.nn.softmax(tst.nn.fc(h, 4))
            tst.amp.rewrite_program(main)
            feed = {"x": _feed(8)}
            ref = port_exe().run(main, feed=feed, fetch_list=[out])[0]
            main.save(str(tmp_path / "r.ptprog"))
            doc_types = {json.load(open(str(tmp_path / "r.ptprog")))[
                "vars"][str(main.ops[0].out_slots[0])]["dtype"]}
        assert doc_types == {"bfloat16"}
        prog, params = tst.load_program(str(tmp_path / "r.ptprog"), "cpu")
        with tst.scope_guard(dict(params)):
            got = port_exe().run(prog, feed=feed,
                                 fetch_list=[prog.vars[out.slot]])[0]
    np.testing.assert_array_equal(got, ref)


def test_passes_on_an_ernie_program(tmp_path):
    """The document, static.amp and the quantization passes on a Program
    recorded from `models.ErnieForSequenceClassification` (2 layers,
    hidden 64, S 128 so the flash path records): a round trip replays
    exactly; after rewrite_program the logits stay within bf16 rounding
    (2e-2 x max(1, |x|)) of fp32; after QAT + freeze the layer-held
    Linear weights are int8 and the logits within 0.05 x max(1, |x|)."""
    from paddle_tpu_torch.quantization import (QuantizationFreezePass,
                                               QuantizationTransformPass)
    c = T.models.ErnieConfig.tiny()
    c.hidden_size, c.num_hidden_layers = 64, 2
    c.num_attention_heads, c.intermediate_size = 2, 128
    c.hidden_dropout_prob = c.attention_probs_dropout_prob = 0.0
    net = T.models.ErnieForSequenceClassification(c, device="cpu").eval()
    B, S = 2, 128
    rng = np.random.RandomState(9)
    feed = {"input_ids": rng.randint(1, 1000, (B, S)).astype("int64"),
            "attention_mask": np.ones((B, S), "int64")}
    feed["attention_mask"][1, 70:] = 0

    def build():
        main = tst.Program()
        with tst.program_guard(main, tst.Program()):
            x = tst.data("input_ids", [B, S], "int64")
            m = tst.data("attention_mask", [B, S], "int64")
            out = net(x, attention_mask=m)
        return main, out
    with static_both(), tst.scope_guard({}):
        main, out = build()
        assert [op.name for op in main.ops].count("sdpa") == 2
        exe = port_exe()
        ref = exe.run(main, feed=feed, fetch_list=[out])[0]
        main.save(str(tmp_path / "e.ptprog"))
        prog, params = tst.load_program(str(tmp_path / "e.ptprog"), "cpu")
        with tst.scope_guard(dict(params)):
            got = exe.run(prog, feed=feed,
                          fetch_list=[prog.vars[out.slot]])[0]
        np.testing.assert_array_equal(got, ref)
        amp_prog, amp_out = build()
        tst.amp.rewrite_program(amp_prog)
        close(exe.run(amp_prog, feed=feed, fetch_list=[amp_out])[0], ref,
              2e-2)
        q_prog, q_out = build()
        QuantizationTransformPass().apply(q_prog)
        QuantizationFreezePass().apply(q_prog)
        frozen = [op for op in q_prog.ops if op.attrs.get("frozen")]
        assert len(frozen) == 2 * 3 + 2   # out proj, 2 FFN; pooler, head
        close(exe.run(q_prog, feed=feed, fetch_list=[q_out])[0], ref, 0.05)
