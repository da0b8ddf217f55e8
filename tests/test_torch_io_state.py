"""paddle.save / paddle.load and hapi `Model.save` / `Model.load` held to
the JAX package's format (pickled numpy arrays, protocol 4), and
`Model.save(training=False)` held to the JAX package's export.

- R1: `Model.save(path, training=False)` exports through `jit.save` with
  the model's `inputs` specs, in both packages; the port's artifact,
  loaded on the CPU, serves a batch of 3 equal to eager (1e-5), and so
  does the JAX package's (a row at a time: its ERNIE export falls back
  to batch 1), on the same weights.
- R2: each package's `load` opens the other's `.pdparams`; names and
  layouts stay each package's own (the port's Linear weights [out, in]),
  and weights cross packages through `models.load_reference_state`. A
  fit -> save -> fresh Model -> load -> evaluate round trip gives the
  same loss, with and without `reset_optimizer`; without it the next
  step equals the uninterrupted run's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import models as jmodels
from paddle_tpu.static.input_spec import InputSpec as JSpec
import paddle_tpu_torch as ptt
from paddle_tpu_torch import hapi, io, jit, models, nn, optimizer
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.static import InputSpec

SEQ = 16
TOL = 1e-5


def _ernie_cfg(cls):
    cfg = cls.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _arrays(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _ernie_pair():
    paddle.seed(4)
    jnet = jmodels.ErnieForSequenceClassification(
        _ernie_cfg(jmodels.ErnieConfig))
    tnet = models.ErnieForSequenceClassification(
        _ernie_cfg(models.ErnieConfig), device="cpu")
    load_reference_state(tnet, _arrays(jnet))
    jnet.eval()
    return jnet, tnet.eval()


def _batch(rows, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 1024, size=(rows, SEQ)).astype("int64")
    types = rng.randint(0, 2, size=(rows, SEQ)).astype("int64")
    return ids, types


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(
        1.0, float(np.abs(want).max())))


def test_model_save_for_inference_exports_as_jax(tmp_path):
    jnet, tnet = _ernie_pair()
    jm = paddle.Model(jnet, inputs=[JSpec([None, SEQ], "int64"),
                                    JSpec([None, SEQ], "int64")])
    tm = hapi.Model(tnet, inputs=[InputSpec([None, SEQ], "int64"),
                                  InputSpec([None, SEQ], "int64")])
    jm.save(str(tmp_path / "jax"), training=False)
    tm.save(str(tmp_path / "port"), training=False)
    ids, types = _batch(3, seed=0)
    served = jit.load(str(tmp_path / "port"), device="cpu")(
        torch.from_numpy(ids), torch.from_numpy(types))
    with torch.no_grad():
        eager = tnet(torch.from_numpy(ids), torch.from_numpy(types))
    assert tuple(served.shape) == (3, 2)
    _close(served.numpy(), eager.numpy())
    # the JAX package's ERNIE export keeps no symbolic batch dim (it
    # falls back to the saved batch 1, with a warning): rows one at a time
    jpred = jinference.create_predictor(jinference.Config(
        str(tmp_path / "jax")))
    jserved = np.concatenate([jpred.run([ids[i:i + 1], types[i:i + 1]])[0]
                              for i in range(3)])
    jeager = np.asarray(jnet(paddle.to_tensor(ids),
                             paddle.to_tensor(types)).numpy())
    _close(jserved, jeager)
    _close(served.numpy(), jserved)


def test_save_is_pickled_numpy_protocol_4(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "h": torch.ones(2, dtype=torch.bfloat16),
             "step": 3, "nested": [torch.tensor([1, 2], dtype=torch.int32)]}
    p = str(tmp_path / "obj.pdparams")
    ptt.save(state, p)
    raw = open(p, "rb").read()
    assert raw[:2] == b"\x80\x04"
    back = ptt.load(p)
    assert isinstance(back["w"], np.ndarray) and back["step"] == 3
    np.testing.assert_array_equal(back["w"], state["w"].numpy())
    assert back["h"].dtype == np.float32     # numpy has no bfloat16
    assert back["nested"][0].dtype == np.int32
    ref = paddle.load(p)
    np.testing.assert_array_equal(ref["w"], back["w"])


def test_reference_load_opens_the_port_pdparams(tmp_path):
    jnet, tnet = _ernie_pair()
    hapi.Model(tnet).save(str(tmp_path / "ck"))
    got = paddle.load(str(tmp_path / "ck.pdparams"))
    own = tnet.state_dict()
    assert set(got) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    # the port's names and layouts: a Linear weight is [out, in]
    w = "classifier.weight"
    assert got[w].shape == _arrays(jnet)[w].shape[::-1]
    load_reference_state(tnet, _arrays(jnet))   # the cross-package route


def test_port_load_opens_a_reference_file(tmp_path):
    jnet, tnet = _ernie_pair()
    p = str(tmp_path / "ref.pdparams")
    paddle.save(jnet.state_dict(), p)
    got = ptt.load(p)
    want = _arrays(jnet)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fresh = models.ErnieForSequenceClassification(
        _ernie_cfg(models.ErnieConfig), device="cpu", seed=9)
    load_reference_state(fresh, got)
    for k, v in tnet.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)


def test_set_state_dict_casts_to_the_parameter_type(tmp_path):
    net = torch.nn.Linear(3, 2).to(torch.bfloat16)
    p = str(tmp_path / "bf16.pdparams")
    ptt.save(net.state_dict(), p)
    other = torch.nn.Linear(3, 2).to(torch.bfloat16)
    ptt.framework.io_state.set_state_dict(other, ptt.load(p))
    assert other.weight.dtype == torch.bfloat16
    assert torch.equal(other.weight, net.weight)


def _gpt_model(seed):
    net = models.GPTForCausalLM(models.GPTConfig.tiny(dropout=0.0),
                                device="cpu", seed=seed)
    return hapi.Model(net).prepare(optimizer.AdamW(1e-3),
                                   nn.CrossEntropyLoss())


def _tokens(seed):
    ids = np.random.RandomState(seed).randint(0, 512, (8, 17))
    return io.TensorDataset([ids[:, :-1], ids[:, 1:]])


@pytest.mark.parametrize("reset_optimizer", [False, True])
def test_fit_save_load_evaluate_round_trip(tmp_path, reset_optimizer):
    model = _gpt_model(0)
    model.fit(_tokens(1), batch_size=4, epochs=1, shuffle=False, verbose=0)
    model.save(str(tmp_path / "gpt"))
    want = model.evaluate(_tokens(2), batch_size=4, verbose=0)["loss"]
    fresh = _gpt_model(5)
    fresh.load(str(tmp_path / "gpt"), reset_optimizer=reset_optimizer)
    got = fresh.evaluate(_tokens(2), batch_size=4, verbose=0)["loss"]
    assert got == want
    ids = np.random.RandomState(3).randint(0, 512, (4, 17))
    (a,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]])
    (b,), _ = fresh.train_batch([ids[:, :-1]], [ids[:, 1:]])
    assert float(a) == float(b)   # the step's loss reads the loaded weights
    pa = dict(model.network.named_parameters())
    pb = dict(fresh.network.named_parameters())
    same = all(torch.equal(pa[k], pb[k]) for k in pa)
    # with the moments and the step count restored the update is the
    # uninterrupted run's; reset, Adam restarts and moves elsewhere
    assert same is (not reset_optimizer)
