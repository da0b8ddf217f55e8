"""The port's inference Analyzer and engine ops (`inference.analysis`;
reference `inference/analysis/` Analyzer pass pipeline,
`operators/lite/lite_engine_op.h` / `tensorrt_engine_op.h` subgraph
engines; `tests/test_inference_analysis.py`): an engine op's outputs
equal the unfused Program's exactly (its body replays the same ops), and
the JAX package's on the same Program within 1e-6 x max(1, |ref|)."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu.inference import compile_subgraph_engine as jax_engine
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.framework.errors import NotFoundError
from paddle_tpu_torch.inference import (Analyzer, Argument,
                                        compile_subgraph_engine)

from torch_static_parity import close, on_the_cpu, port_exe  # noqa: F401


def _build(P, st, path=None):
    P.enable_static()
    try:
        main = st.Program()
        with st.program_guard(main, st.Program()):
            x = st.data("x", [2, 4], "float32")
            h = x * 2.0
            h2 = h + 1.0
            out = (h2 * h2).sum()
        if path:
            main.save(path)
    finally:
        P.disable_static()
    return main, out


def test_engine_subgraph_preserves_outputs_as_jax():
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4)}
    tm, to = _build(T, tst)
    jm, jo = _build(J, jst)
    before = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    idx = compile_subgraph_engine(tm, 0, len(tm.ops), fetch_slots=[to.slot])
    jidx = jax_engine(jm, 0, len(jm.ops), fetch_slots=[jo.slot])
    eng = tm.ops[idx]
    assert eng.type == "torch_engine" and idx == jidx
    assert eng.attr("num_fused_ops") == jm.ops[jidx].attr("num_fused_ops")
    assert eng.attr("fused_op_types") == jm.ops[jidx].attr("fused_op_types")
    assert "multiply" in eng.attr("fused_op_types")
    after = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    np.testing.assert_array_equal(after, before)
    close(after, jst.Executor().run(jm, feed=feed, fetch_list=[jo])[0],
          1e-6)


def test_engine_partial_range():
    feed = {"x": np.ones((2, 4), "float32")}
    tm, to = _build(T, tst)
    before = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    n = len(tm.ops)
    compile_subgraph_engine(tm, 1, n - 1, engine_type="lite")
    assert any(op.type == "lite_engine" for op in tm.ops)
    assert len(tm.ops) < n + 1
    np.testing.assert_array_equal(
        port_exe().run(tm, feed=feed, fetch_list=[to])[0], before)


def test_analyzer_pipeline_from_file(tmp_path):
    path = str(tmp_path / "prog.json")
    _, out = _build(T, tst, path)
    arg = Argument(model_path=path, device="cpu")
    Analyzer().run(arg)
    assert arg.program is not None and arg.engine_ops
    assert arg.program.ops[arg.engine_ops[0]].type == "torch_engine"
    feed = {"x": np.full((2, 4), 3.0, "float32")}
    got = port_exe().run(arg.program, feed=feed,
                         fetch_list=[arg.program.vars[out.slot]])[0]
    np.testing.assert_allclose(float(got), float(
        (((np.full((2, 4), 3.0) * 2) + 1) ** 2).sum()), rtol=1e-6)


def test_engine_program_serializes(tmp_path):
    """An engine op is one op of the Program: it exports with the rest
    (its body traced through) and replays after a reload."""
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4)}
    tm, to = _build(T, tst)
    ref = port_exe().run(tm, feed=feed, fetch_list=[to])[0]
    compile_subgraph_engine(tm, 0, len(tm.ops), fetch_slots=[to.slot])
    tm.save(str(tmp_path / "e.json"))
    loaded, _ = tst.load_program(str(tmp_path / "e.json"), "cpu")
    assert [op.type for op in loaded.ops] == ["torch_engine"]
    np.testing.assert_array_equal(port_exe().run(
        loaded, feed=feed, fetch_list=[loaded.vars[to.slot]])[0], ref)


def test_analyzer_unknown_pass_rejected():
    with pytest.raises(NotFoundError):
        Analyzer(["no_such_pass"]).run(Argument(program=tst.Program()))
