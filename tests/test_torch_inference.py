"""paddle_tpu_torch.inference held to paddle_tpu.inference: the Predictor
cases of tests/test_serving_engine.py, each run through both packages on
artifacts of the same weights (the serving MLP, 8 -> 16 -> tanh -> 4,
carried by `load_reference_state`), float32 on the CPU
(`Config.disable_gpu()`):

- `Config.set_model` keeps the options and strips `.pdmodel`;
- every validation error's message is the JAX package's word for word
  (rank, dim, dtype, input count, an input never fed), and a same-kind
  dtype (float64) is cast, not refused;
- the symbolic batch: the signature reads (None, 8) float32 and batch 1
  and 13 are served from one artifact, within 1e-5 x max(1, max |ref|)
  of the JAX predictor;
- `compile_count` / `STAT_predictor_compiles` move once per distinct
  input shape, as the JAX package's per-shape traces;
- a fixed-shape artifact refuses another batch with the JAX message;
- the handle API (`get_input_handle().copy_from_cpu`, `run()`,
  `get_output_handle().copy_to_cpu`); `clone_for_device`;
- `Config()` asks for the card: without one, `create_predictor` raises;
  a `.pdmodel` that is not a `torch.export` artifact raises
  UnimplementedError (the legacy ProgramDesc import is not ported).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.static.input_spec import InputSpec as JSpec
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import (UnavailableError,
                                               UnimplementedError)
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.static import InputSpec

TOL = 1e-5


class _JMlp(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(paddle.tanh(self.fc1(x)))


class _TMlp(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16)
        self.fc2 = tnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(tpkg.tanh(self.fc1(x)))


def _x(rows, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (rows, 8)).astype("float32")


def _pair_saved(d, spec_shape, seed=7):
    paddle.seed(seed)
    jnet, tnet = _JMlp(), _TMlp()
    load_reference_state(tnet, {k: np.asarray(v.numpy())
                                for k, v in jnet.state_dict().items()})
    paddle.jit.save(jnet, str(d / "jax"),
                    input_spec=[JSpec(spec_shape, "float32")])
    jit.save(tnet, str(d / "port"),
             input_spec=[InputSpec(spec_shape, "float32")])
    return str(d / "jax"), str(d / "port")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _pair_saved(tmp_path_factory.mktemp("infer"), [None, 8])


def _cpu_config(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


def _predictors(artifacts):
    jprefix, prefix = artifacts
    return (jinference.create_predictor(jinference.Config(jprefix)),
            inference.create_predictor(_cpu_config(prefix)))


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())))


def test_set_model_preserves_options(artifacts):
    jprefix, prefix = artifacts
    for mod, p in ((jinference, jprefix), (inference, prefix)):
        cfg = mod.Config()
        cfg.set_cpu_math_library_num_threads(7)
        cfg.enable_profile()
        cfg.enable_use_gpu(memory_pool_init_size_mb=333)
        cfg.set_model(p + ".pdmodel", p + ".pdiparams")
        assert cfg._threads == 7
        assert cfg._enable_profile is True
        assert cfg._memory_pool_mb == 333
        assert cfg.model_path == p
        assert cfg.params_file == p + ".pdiparams"
    cfg.disable_gpu()
    assert inference.create_predictor(cfg).run([_x(1)])[0].shape == (1, 4)


BAD_FEEDS = {
    "rank": lambda p: p.run([np.zeros((2, 8, 1), "float32")]),
    "dim": lambda p: p.run([np.zeros((2, 9), "float32")]),
    "dtype": lambda p: p.run([np.zeros((2, 8), "complex64")]),
    "count": lambda p: p.run([np.zeros((2, 8), "float32")] * 2),
    "never_fed": lambda p: p.run(),
}


@pytest.mark.parametrize("case", sorted(BAD_FEEDS))
def test_validation_messages_match_jax(artifacts, case):
    jpred, pred = _predictors(artifacts)
    with pytest.raises(ValueError) as want:
        BAD_FEEDS[case](jpred)
    with pytest.raises(ValueError) as got:
        BAD_FEEDS[case](pred)
    assert str(got.value) == str(want.value)
    if case == "dim":
        assert "float32[b,8]" in str(got.value)


def test_safe_cast_accepted(artifacts):
    jpred, pred = _predictors(artifacts)
    x = _x(2).astype("float64")
    got, want = pred.run([x])[0], jpred.run([x])[0]
    assert got.dtype == want.dtype == np.float32
    _close(got, want)


def test_symbolic_batch_artifact_serves_any_batch(artifacts):
    jpred, pred = _predictors(artifacts)
    name, dims, dtype = pred.input_signature()[0]
    assert (name, dims, dtype) == jpred.input_signature()[0]
    assert dims == (None, 8) and dtype == np.dtype("float32")
    for rows in (1, 13):
        got = pred.run([_x(rows, rows)])[0]
        assert got.shape == (rows, 4)
        _close(got, jpred.run([_x(rows, rows)])[0])


def test_compile_counter_once_per_shape(artifacts):
    jpred, pred = _predictors(artifacts)
    deltas = []
    for p, mon in ((jpred, jmonitor), (pred, monitor)):
        c0 = mon.stat_get("STAT_predictor_compiles")
        seen = []
        for _ in range(3):
            p.run([_x(2)])
        seen.append(mon.stat_get("STAT_predictor_compiles") - c0)
        p.run([_x(6)])
        seen.append(mon.stat_get("STAT_predictor_compiles") - c0)
        seen.append(p.compile_count)
        deltas.append(seen)
    assert deltas[1] == deltas[0] == [1, 2, 2]


def test_fixed_shape_artifact(tmp_path):
    jprefix, prefix = _pair_saved(tmp_path, [2, 8], seed=3)
    jpred = jinference.create_predictor(jinference.Config(jprefix))
    pred = inference.create_predictor(_cpu_config(prefix))
    assert pred.input_signature()[0][1] == (2, 8)
    with pytest.raises(ValueError, match=r"dim 0 must be 2") as got:
        pred.run([_x(3)])
    with pytest.raises(ValueError) as want:
        jpred.run([_x(3)])
    assert str(got.value) == str(want.value)
    _close(pred.run([_x(2)])[0], jpred.run([_x(2)])[0])


def test_handle_api(artifacts):
    _, pred = _predictors(artifacts)
    x = _x(3, 5)
    assert pred.get_input_names() == ["input_0"]
    pred.get_input_handle("input_0").copy_from_cpu(x)
    assert pred.run() is True
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, pred.run([x])[0])


def test_clone_for_device_shares_the_artifact(artifacts):
    _, pred = _predictors(artifacts)
    pred.run([_x(2)])
    clone = pred.clone_for_device("cpu")
    assert clone._translated is pred._translated
    assert clone.compile_count == 0 and pred.compile_count == 1
    np.testing.assert_array_equal(clone.run([_x(2)])[0],
                                  pred.run([_x(2)])[0])
    assert clone.compile_count == 1


def test_default_config_asks_for_the_card(artifacts):
    _, prefix = artifacts
    cfg = inference.Config(prefix)
    assert cfg.use_gpu()
    if torch.cuda.is_available():
        assert inference.create_predictor(cfg).device.type == "cuda"
    else:
        with pytest.raises(UnavailableError):
            inference.create_predictor(cfg)


def test_non_export_artifact_is_unimplemented(tmp_path):
    (tmp_path / "legacy.pdmodel").write_bytes(b"\x08\x01not a pt2 archive")
    cfg = _cpu_config(str(tmp_path / "legacy"))
    with pytest.raises(UnimplementedError, match="ProgramDesc"):
        inference.create_predictor(cfg)
