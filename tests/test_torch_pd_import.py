"""The port's reference `.pdmodel` / `.pdiparams` import
(`inference.pd_format`, `inference.pd_import`, and `inference.Predictor`
on a legacy ProgramDesc) against the JAX package's loader, on
protobuf-encoded fixtures: `tests/test_pd_import.py`'s MLP (its encoder,
imported) and the committed transformer encoder of
`tests/data/pd_encoder.*` (`tests/torch_pd_fixture.py`), which these
tests re-encode byte for byte.

Tolerances: 1e-5 x max(1, max |ref|) against the JAX loader (fp32
summation order); the MLP against numpy as `tests/test_pd_import.py`
holds it (rtol 1e-5, atol 1e-6)."""
import os

import numpy as np
import pytest
import torch

pb = pytest.importorskip("google.protobuf")

import paddle_tpu_torch as T  # noqa: E402
import torch_pd_fixture as fx  # noqa: E402
from paddle_tpu.inference.pd_import import \
    load_legacy_inference_model as jax_load  # noqa: E402
from paddle_tpu_torch.framework.errors import (UnavailableError,  # noqa
                                               UnimplementedError)
from paddle_tpu_torch.inference import pd_format  # noqa: E402
from paddle_tpu_torch.inference.pd_import import \
    load_legacy_inference_model  # noqa: E402
from test_pd_import import (_build_mlp_pdmodel, _make_classes,  # noqa: E402
                            _write_combined_params)

from torch_static_parity import close, on_the_cpu  # noqa: E402,F401

ENC = os.path.join(fx.DATA, fx.NAME)


@pytest.fixture(scope="module")
def mlp_model(tmp_path_factory):
    C = _make_classes()
    d = tmp_path_factory.mktemp("pdmodel")
    model_path = str(d / "model.pdmodel")
    with open(model_path, "wb") as f:
        f.write(_build_mlp_pdmodel(C).SerializeToString())
    rs = np.random.RandomState(0)
    params = {"w1": rs.standard_normal((8, 16)).astype("float32"),
              "b1": rs.standard_normal((16,)).astype("float32"),
              "w2": rs.standard_normal((16, 3)).astype("float32"),
              "b2": rs.standard_normal((3,)).astype("float32")}
    params_path = str(d / "model.pdiparams")
    _write_combined_params(C, params, params_path)
    return model_path, params_path, params


def test_committed_fixture_reencodes_byte_for_byte():
    model, prm = fx.encode()
    with open(ENC + ".pdmodel", "rb") as f:
        assert f.read() == model
    with open(ENC + ".pdiparams", "rb") as f:
        assert f.read() == prm
    assert len(model) + len(prm) < 32 * 1024


def test_parse_program_desc_equals_jax(mlp_model):
    from paddle_tpu.inference.pd_format import parse_program_desc as jparse
    for path in (mlp_model[0], ENC + ".pdmodel"):
        with open(path, "rb") as f:
            data = f.read()
        a, b = jparse(data), pd_format.parse_program_desc(data)
        assert repr(b) == repr(a)
    blk = pd_format.parse_program_desc(open(ENC + ".pdmodel", "rb").read(
    ))["blocks"][0]
    types = [o["type"] for o in blk["ops"]]
    assert {"lookup_table_v2", "layer_norm", "matmul", "softmax",
            "reshape2", "transpose2", "gelu", "slice", "tanh"} <= set(types)
    assert blk["vars"]["ids"]["shape"] == [-1, 8]


def test_mlp_matches_numpy_and_jax(mlp_model):
    model_path, params_path, params = mlp_model
    m = load_legacy_inference_model(model_path, params_path, device="cpu")
    assert m.feed_names == ["x"] and m.fetch_names == ["out"]
    x = np.random.RandomState(1).standard_normal((4, 8)).astype("float32")
    got = m.run({"x": x})[0]
    h = np.maximum(x @ params["w1"] + params["b1"], 0)
    logits = h @ params["w2"] + params["b2"]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(-1, keepdims=True), rtol=1e-5,
                               atol=1e-6)
    close(got, jax_load(model_path, params_path).run({"x": x})[0], 1e-5)


def test_encoder_matches_jax():
    m = load_legacy_inference_model(ENC + ".pdmodel", ENC + ".pdiparams",
                                    device="cpu")
    ids, pos = fx.feeds()
    got = m.run({"ids": ids, "pos": pos})[0]
    want = jax_load(ENC + ".pdmodel", ENC + ".pdiparams").run(
        {"ids": ids, "pos": pos})[0]
    assert got.shape == (3, fx.CLASSES)
    close(got, want, 1e-5)


@pytest.mark.parametrize("which", ["mlp", "encoder"])
def test_predictor_loads_a_legacy_pdmodel(which, mlp_model):
    """inference.Predictor runs a reference ProgramDesc where the file is
    not a torch.export artifact (on the CPU when asked)."""
    from paddle_tpu_torch import inference
    if which == "mlp":
        model, params = mlp_model[0], mlp_model[1]
        feeds = [np.random.RandomState(2).standard_normal(
            (2, 8)).astype("float32")]
    else:
        model, params = ENC + ".pdmodel", ENC + ".pdiparams"
        feeds = list(fx.feeds(batch=2, seed=3))
    cfg = inference.Config(model, params)
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    got = pred.run(feeds)[0]
    m = load_legacy_inference_model(model, params, device="cpu")
    want = m.run(dict(zip(m.feed_names, feeds)))[0]
    np.testing.assert_array_equal(got, want)
    assert pred.get_input_names() == m.feed_names
    with pytest.raises(ValueError):
        pred.run([feeds[0][:, :3]] + feeds[1:])


def test_unmapped_op_raises_naming_it(tmp_path):
    C = _make_classes()
    prog = _build_mlp_pdmodel(C)
    prog.blocks[0].ops[3].type = "no_such_op"
    path = str(tmp_path / "bad.pdmodel")
    with open(path, "wb") as f:
        f.write(prog.SerializeToString())
    with pytest.raises(UnimplementedError, match="no_such_op"):
        load_legacy_inference_model(path, device="cpu")


def test_neither_format_raises_unimplemented(tmp_path):
    from paddle_tpu_torch import inference
    path = str(tmp_path / "junk")
    with open(path + ".pdmodel", "wb") as f:
        f.write(b"\x00\x01not a model")
    cfg = inference.Config(path)
    cfg.disable_gpu()
    with pytest.raises(UnimplementedError, match="nor a parseable"):
        inference.create_predictor(cfg)


def test_predictor_takes_the_card_by_default():
    from paddle_tpu_torch import inference
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UnavailableError):
        inference.create_predictor(inference.Config(ENC + ".pdmodel",
                                                    ENC + ".pdiparams"))
    with pytest.raises(UnavailableError):
        load_legacy_inference_model(ENC + ".pdmodel", ENC + ".pdiparams",
                                    device=T.CUDAPlace(0))
