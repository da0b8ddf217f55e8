"""paddle_tpu_torch.jit.save / load held to paddle_tpu.jit.save ->
paddle_tpu.inference on the same weights.

Artifacts are built once per module (module-scoped fixtures) in pytest's
temporary directories, from numpy-seeded weights carried from the JAX
layer by `load_reference_state`, float32 on the CPU:

- the serving MLP (8 -> 16 -> tanh -> 4, as tests/test_serving_engine.py
  saves it) with `InputSpec([None, 8])`: one artifact serves batch 1
  through 7 (the port's artifact traced at batch 2, so the batch dim is
  not specialised), each batch within 1e-5 x max(1, max |ref|) of the
  JAX artifact run through `paddle_tpu.inference`; the manifest's input
  dims and types equal the JAX package's;
- ERNIE-tiny (2 layers, hidden 128, 4 heads of 32) at seq 128 with
  FLAGS_flash_attention_min_seq 128 in both packages, saved with
  `InputSpec([None, 128], "int64")` for the ids and for the
  attention_mask: the exported graph holds one
  `paddle_tpu_torch.flash_fwd` node a layer and no softmax (no plain
  attention is baked in), and batches 1, 3 and 5 equal the JAX artifact
  within 1e-5 (the JAX side's Pallas flash kernels in interpret mode,
  whose export refuses symbolic dims and falls back to batch 1, so it
  runs a row at a time; the port's op on its plain version);
- the weight-only-quantized MLP (int8 and int4), the JAX package's
  integers carried across: the integer weights and scales are leading
  arguments of the program and not its state, `STAT_quant_exports`
  moves by 1 a save, `STAT_quant_weight_hbm_bytes` by the integer and
  scale bytes while the loaded layer lives, and the outputs equal the
  eager quantized model's exactly and the JAX artifact's within 1e-5;
- `save` requires an input spec unless `to_static` kept one; a fixed
  spec gives a fixed-shape program.
"""
import gc
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu import models as jmodels
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.quantization import quantize_weights as jquantize
from paddle_tpu.static.input_spec import InputSpec as JSpec
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import jit, models, quantization
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.static import InputSpec

TOL = 1e-5
SEQ = 128


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _arrays(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


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


def _jpredictor(prefix):
    return jinference.create_predictor(jinference.Config(prefix))


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """(JAX artifact prefix, port artifact prefix, port model)."""
    d = tmp_path_factory.mktemp("jit_mlp")
    paddle.seed(7)
    jnet = _JMlp()
    tnet = _TMlp()
    load_reference_state(tnet, _arrays(jnet))
    paddle.jit.save(jnet, str(d / "jax"),
                    input_spec=[JSpec([None, 8], "float32")])
    jit.save(tnet, str(d / "port"),
             input_spec=[InputSpec([None, 8], "float32")])
    return str(d / "jax"), str(d / "port"), tnet


@pytest.mark.parametrize("batch", range(1, 8))
def test_mlp_artifact_serves_any_batch_as_jax(mlp, batch):
    jprefix, prefix, tnet = mlp
    layer = jit.load(prefix, device="cpu")
    x = _x(batch, seed=batch)
    got = layer(torch.from_numpy(x))
    want = _jpredictor(jprefix).run([x])[0]
    assert tuple(got.shape) == (batch, 4)
    _close(got.numpy(), want, f"batch {batch}")
    _close(got.numpy(), tnet(torch.from_numpy(x)).detach().numpy())


def test_mlp_manifest_and_signature_match_jax(mlp):
    jprefix, prefix, _ = mlp
    assert jit.load_meta(prefix)["input_specs"] == \
        paddle.jit.load_meta(jprefix)["input_specs"] == [(("b", 8),
                                                          "float32")]
    assert jit.load(prefix, device="cpu").user_inputs() == [
        ((None, 8), torch.float32)]
    assert set(os.listdir(os.path.dirname(prefix))) >= {
        "port.pdmodel", "port.pdiparams", "port.pdmeta"}


# -- ERNIE-tiny through the flash op -------------------------------------------------

class _JCls(jnn.Layer):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, ids, mask):
        return self.net(ids, attention_mask=mask)


class _TCls(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, ids, mask):
        return self.net(ids, attention_mask=mask)


def _ernie_cfg(cls):
    cfg = cls.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


@pytest.fixture(scope="module")
def flash_at_128():
    jold = get_flags(["FLAGS_flash_attention_min_seq",
                      "FLAGS_flash_attention_interpret"])
    told = tflags.get_flags(["FLAGS_flash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_min_seq": 128,
               "FLAGS_flash_attention_interpret": True})
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    set_flags(jold)
    tflags.set_flags(told)


@pytest.fixture(scope="module")
def ernie(tmp_path_factory, flash_at_128):
    """(JAX artifact prefix, port artifact prefix)."""
    d = tmp_path_factory.mktemp("jit_ernie")
    paddle.seed(3)
    jnet = jmodels.ErnieForSequenceClassification(
        _ernie_cfg(jmodels.ErnieConfig))
    tnet = models.ErnieForSequenceClassification(
        _ernie_cfg(models.ErnieConfig), device="cpu")
    load_reference_state(tnet, _arrays(jnet))
    specs = [JSpec([None, SEQ], "int64"), JSpec([None, SEQ], "int64")]
    paddle.jit.save(_JCls(jnet), str(d / "jax"), input_spec=specs)
    jit.save(_TCls(tnet), str(d / "port"),
             input_spec=[InputSpec([None, SEQ], "int64"),
                         InputSpec([None, SEQ], "int64")])
    return str(d / "jax"), str(d / "port")


def _ernie_inputs(rows, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 1024, size=(rows, SEQ)).astype("int64")
    lens = rng.randint(SEQ // 4, SEQ + 1, size=rows)
    lens[0] = SEQ
    mask = (np.arange(SEQ)[None] < lens[:, None]).astype("int64")
    return ids, mask


def test_ernie_graph_holds_the_flash_op(ernie):
    _, prefix = ernie
    graph = jit.load(prefix, device="cpu")._exported.graph
    targets = [str(n.target) for n in graph.nodes
               if n.op == "call_function"]
    assert sum(t == "paddle_tpu_torch.flash_fwd.default"
               for t in targets) == 2
    assert not any("softmax" in t for t in targets)


@pytest.mark.parametrize("rows", [1, 3, 5])
def test_ernie_artifact_matches_jax(ernie, rows):
    jprefix, prefix = ernie
    ids, mask = _ernie_inputs(rows, seed=rows)
    got = jit.load(prefix, device="cpu")(torch.from_numpy(ids),
                                         torch.from_numpy(mask))
    # the JAX export of its interpret-mode Pallas kernels refuses symbolic
    # dims and falls back to batch 1 (with a warning): rows one at a time
    jpred = _jpredictor(jprefix)
    assert jpred.input_signature()[0][1] == (1, SEQ)
    want = np.concatenate([jpred.run([ids[i:i + 1], mask[i:i + 1]])[0]
                           for i in range(rows)])
    assert tuple(got.shape) == (rows, 2)
    _close(got.numpy(), want, f"rows {rows}")


# -- weight-only quantized export ----------------------------------------------------

@pytest.fixture(scope="module", params=[8, 4])
def qmlp(request, tmp_path_factory):
    """(bits, JAX artifact prefix, port artifact prefix, port model,
    STAT_quant_exports moved by the port's save)."""
    bits = request.param
    d = tmp_path_factory.mktemp(f"jit_q{bits}")
    paddle.seed(11)
    jnet = jquantize(_JMlp(), bits=bits)
    tnet = quantization.quantize_weights(_TMlp(), bits=bits)
    load_reference_state(tnet, _arrays(jnet))
    paddle.jit.save(jnet, str(d / "jax"),
                    input_spec=[JSpec([None, 8], "float32")])
    q0 = monitor.stat_get("STAT_quant_exports")
    jit.save(tnet, str(d / "port"),
             input_spec=[InputSpec([None, 8], "float32")])
    moved = monitor.stat_get("STAT_quant_exports") - q0
    return bits, str(d / "jax"), str(d / "port"), tnet, moved


def test_quantized_export_matches_eager_and_jax(qmlp):
    bits, jprefix, prefix, tnet, moved = qmlp
    assert moved == 1
    qname = "weight_int8" if bits == 8 else "weight_int4"
    meta = jit.load_meta(prefix)["quant"]
    assert meta["args"] == [f"fc1.{qname}", "fc1.weight_scale",
                            f"fc2.{qname}", "fc2.weight_scale"]
    assert meta == paddle.jit.load_meta(jprefix)["quant"]
    g0 = monitor.stat_get("STAT_quant_weight_hbm_bytes")
    layer = jit.load(prefix, device="cpu")
    want_bytes = sum(t.numel() * t.element_size()
                     for n, t in tnet.state_dict().items()
                     if n in meta["args"])
    assert monitor.stat_get("STAT_quant_weight_hbm_bytes") - g0 == \
        want_bytes
    # integers ride as arguments: the program's own state holds none
    held = layer._exported.state_dict
    assert all(held[f"layer.{n}"].numel() == 0 for n in meta["args"])
    x = _x(5, seed=3)
    got = layer(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), tnet(torch.from_numpy(x)).detach().numpy())
    _close(got.numpy(), _jpredictor(jprefix).run([x])[0])
    del layer
    gc.collect()
    assert monitor.stat_get("STAT_quant_weight_hbm_bytes") == g0


def test_save_requires_input_spec_unless_to_static_kept_one(tmp_path):
    with pytest.raises(ValueError, match="requires input_spec"):
        jit.save(_TMlp(), str(tmp_path / "none"))
    with pytest.raises(TypeError):
        jit.save(lambda x: x, str(tmp_path / "fn"),
                 input_spec=[InputSpec([None, 8])])
    net = jit.to_static(_TMlp(), input_spec=[InputSpec([None, 8],
                                                       "float32")])
    jit.save(net, str(tmp_path / "kept"))
    assert jit.load(str(tmp_path / "kept"), device="cpu").user_inputs() == [
        ((None, 8), torch.float32)]


def test_load_runs_on_the_card_unless_asked_for_the_cpu(mlp):
    _, prefix, tnet = mlp
    if torch.cuda.is_available():
        assert jit.load(prefix).device.type == "cuda"
    else:
        with pytest.raises(UnavailableError, match="cuda"):
            jit.load(prefix)
    # host inputs (numpy included) run on the layer's device
    layer = jit.load(prefix, device="cpu")
    assert layer.device == torch.device("cpu")
    x = _x(3)
    got = layer(x)
    assert got.device == torch.device("cpu")
    _close(got.numpy(), tnet(torch.from_numpy(x)).detach().numpy())


def test_fixed_spec_gives_fixed_program(tmp_path):
    net = _TMlp()
    jit.save(net, str(tmp_path / "fixed"),
             input_spec=[InputSpec([2, 8], "float32")])
    layer = jit.load(str(tmp_path / "fixed"), device="cpu")
    assert layer.user_inputs() == [((2, 8), torch.float32)]
    x = torch.from_numpy(_x(2))
    _close(layer(x).numpy(), net(x).detach().numpy())


def test_to_static_function_runs_eagerly():
    @jit.to_static(input_spec=[InputSpec([None, 3])])
    def f(x):
        return x * 2

    assert f._input_spec[0].shape == (None, 3)
    assert torch.equal(f(torch.ones(2, 3)), torch.full((2, 3), 2.0))
    assert jit.not_to_static(f)._not_to_static
