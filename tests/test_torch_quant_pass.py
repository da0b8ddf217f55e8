"""Program-level quantization passes of the port
(`quantization.quant_pass`) against the JAX package's (reference
`fluid/contrib/slim/quantization/quantization_pass.py`;
`tests/test_quant_pass.py`), and `save_quantized_model`.

The frozen int8 weights and per-channel scales equal the JAX pass's
exactly (the port's `nn.Linear` weight is the transpose of the JAX
package's, so its codes and scales are the transposes). Outputs:
1e-5 x max(1, max |ref|) against the JAX Program on the same weights
(fake-quant and dequantize round the same integers); the JAX test's own
bounds against the float Program."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu.quantization import (QuantizationFreezePass as JFreeze,
                                     QuantizationTransformPass as JTransform)
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.quantization import (QuantizationFreezePass,
                                           QuantizationTransformPass)

from torch_static_parity import (close, copy_scope, on_the_cpu,  # noqa: F401
                                 port_exe, static_both)


def _build(P, st):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [8, 4], "float32")
        h = st.nn.fc(x, 16, activation="relu")
        out = st.nn.fc(h, 2)
    return main, startup, out


def _pair():
    jm, _, jo = _build(J, jst)
    tm, _, to = _build(T, tst)
    copy_scope(jm, tm)
    return (jm, jo), (tm, to)


def _feed(seed):
    return {"x": np.random.RandomState(seed).rand(8, 4).astype("float32")}


def test_transform_pass_matches_jax():
    feed = _feed(0)
    with static_both():
        (jm, jo), (tm, to) = _pair()
        before = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
        JTransform().apply(jm)
        QuantizationTransformPass().apply(tm)
        assert [op.attrs.get("quant") for op in tm.ops] == \
            [op.attrs.get("quant") for op in jm.ops]
        assert any(op.attrs.get("quant") for op in tm.ops)
        want = jst.Executor().run(jm, feed=feed, fetch_list=[jo])[0]
        got = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    close(got, want, 1e-5)
    np.testing.assert_allclose(got, before, rtol=0.2, atol=0.1)
    assert not np.array_equal(got, before)


def _frozen(prog):
    out = []
    for op in prog.ops:
        if op.attrs.get("frozen"):
            consts = [np.asarray(r) for t, r in op.in_refs if t == "c"]
            out.append([c for c in consts if c.dtype == np.int8])
    return out


def test_freeze_pass_int8_weights_and_scales_equal_jax():
    feed = _feed(1)
    with static_both():
        (jm, jo), (tm, to) = _pair()
        before = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
        n_params = len(tm.param_vars)
        JFreeze().apply(jm)
        QuantizationFreezePass().apply(tm)
        jq, tq = _frozen(jm), _frozen(tm)
        assert len(tq) == len(jq) == 2
        for a, b in zip(jq, tq):
            assert len(a) == len(b) == 1
            np.testing.assert_array_equal(b[0].T, a[0])
            assert b[0].std() > 0
        for jop, top in zip([o for o in jm.ops if o.attrs.get("frozen")],
                            [o for o in tm.ops if o.attrs.get("frozen")]):
            assert top.attrs["weight_scale_max"] == \
                jop.attrs["weight_scale_max"]
            jscale = np.asarray(jop.fn.__kwdefaults__["_scale"])
            tscale = top.in_refs[-1][1].numpy()
            np.testing.assert_array_equal(tscale.T, jscale)
        assert len(tm.param_vars) < n_params
        want = jst.Executor().run(jm, feed=feed, fetch_list=[jo])[0]
        got = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    close(got, want, 1e-5)
    np.testing.assert_allclose(got, before, rtol=0.05, atol=0.05)
    assert not np.array_equal(got, before)


def test_frozen_program_serializes_and_reloads(tmp_path):
    feed = {"x": np.ones((8, 4), "float32")}
    with static_both():
        tm, _, to = _build(T, tst)
        QuantizationFreezePass().apply(tm)
        want = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
        path = str(tmp_path / "q.json")
        tm.save(path)
        loaded, params = tst.Program.load(path)
        lop = [op for op in loaded.ops if op.attrs.get("frozen")]
        assert lop and lop[0].attr("weight_bits") == 8
        assert all(p.dim() < 2 for p in params.values())   # int8 only
        sc = dict(tst.global_scope())
        sc.update(params)
        with tst.scope_guard(sc):
            got = port_exe().run(loaded, feed=feed,
                                 fetch_list=[loaded.vars[to.slot]])[0]
    np.testing.assert_array_equal(got, want)


def test_transform_then_freeze_unwraps_qat_as_jax():
    feed = _feed(2)
    with static_both():
        (jm, jo), (tm, to) = _pair()
        ref = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
        JTransform().apply(jm)
        JFreeze().apply(jm)
        QuantizationTransformPass().apply(tm)
        QuantizationFreezePass().apply(tm)
        frozen = [op for op in tm.ops if op.attrs.get("frozen")]
        assert frozen
        for op in frozen:
            assert not op.attrs.get("quant") and op.attrs.get("qat_trained")
        want = jst.Executor().run(jm, feed=feed, fetch_list=[jo])[0]
        got = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    close(got, want, 1e-5)
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


def test_freeze_conv_per_output_channel_equal_jax():
    feed = {"x": np.random.RandomState(3).rand(2, 3, 8, 8).astype(
        "float32")}
    with static_both():
        progs = []
        for P, st in ((J, jst), (T, tst)):
            main = st.Program()
            with st.program_guard(main, st.Program()):
                x = st.data("x", [2, 3, 8, 8], "float32")
                out = st.nn.conv2d(x, 4, 3, padding=1).sum()
            progs.append((main, out))
        (jm, jo), (tm, to) = progs
        copy_scope(jm, tm)
        ref = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
        JFreeze().apply(jm)
        QuantizationFreezePass().apply(tm)
        (ja,), (ta,) = _frozen(jm), _frozen(tm)
        np.testing.assert_array_equal(ta[0], ja[0])
        want = jst.Executor().run(jm, feed=feed, fetch_list=[jo])[0]
        got = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    close(got, want, 1e-5)
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.5)


@pytest.mark.parametrize("kind", ["ImperativeQuantAware", "PTQ"])
def test_save_quantized_model_through_jit_save(kind, tmp_path):
    """Both `save_quantized_model`s write a `jit.save` artifact (as the
    JAX package's do) that a CPU Predictor runs equal to the quantized
    layer eagerly."""
    from paddle_tpu_torch import inference, quantization
    from paddle_tpu_torch.static import InputSpec
    torch.manual_seed(0)
    net = T.nn.Sequential(T.nn.Linear(6, 8), T.nn.ReLU(), T.nn.Linear(8, 3))
    q = getattr(quantization, kind)()
    q.quantize(net)
    prefix = str(tmp_path / "m")
    q.save_quantized_model(net, prefix,
                           input_spec=[InputSpec([None, 6], "float32")])
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    x = np.random.RandomState(4).rand(5, 6).astype("float32")
    got = inference.create_predictor(cfg).run([x])[0]
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
