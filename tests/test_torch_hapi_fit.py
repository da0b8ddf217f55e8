"""The training slice as a whole: paddle_tpu_torch `hapi.Model.fit` held
to paddle_tpu's on the same GPT, data and schedule.

Both sides train `GPTConfig.tiny` widened to 128 (head_dim 32, a head
dim the port's kernels are built for) with dropout 0 at S = 128, with
FLAGS_flash_attention_min_seq = 128 on both, so every attention call
takes flash attention: the JAX side runs its Pallas forward and backward
kernels in interpret mode, the port runs `FlashAttention` on its plain
versions (CPU tensors). AdamW with weight decay, `ClipGradByGlobalNorm`
and `LinearWarmup`, `shuffle=False`, a dataset that is a multiple of the
batch. Per-step losses agree to rtol 1e-4 (float32; the two sides sum in
different orders, and the Pallas kernel sums its softmax online over
tiles). The final parameters agree to atol 1e-4, a thirtieth of one
step's largest move (lr 3e-3): Adam divides by the root of the second
moment, which scales rounding differences of small gradients up. Then
the port alone trains with dropout on: the loss stays finite and
falls."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.framework.monitor import stat_get as jstat_get
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import hapi, io, nn, optimizer
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.ops import flash_ops

S = 128
BATCH = 2
STEPS = 3
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


@pytest.fixture
def flash_at_128():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_use_flash_attention",
                     "FLAGS_flash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_interpret": True,
               "FLAGS_use_flash_attention": True,
               "FLAGS_flash_attention_min_seq": S})
    old_t = tflags.get_flags("FLAGS_flash_attention_min_seq")
    tflags.set_flags({"FLAGS_flash_attention_min_seq": S})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _motif_tokens(n, vocab, seed):
    """n sequences of S + 1 tokens: a short random motif per sequence,
    repeated — learnable, so the loss must fall."""
    rng = np.random.RandomState(seed)
    out = np.empty((n, S + 1), np.int64)
    for i in range(n):
        motif = rng.randint(0, vocab, size=rng.randint(3, 9))
        out[i] = np.resize(motif, S + 1)
    return out


class _JRecorder(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


class _TRecorder(hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


def _counting(monkeypatch, name):
    calls = [0]
    fn = getattr(flash_ops, name)

    def wrapped(*a, **k):
        calls[0] += 1
        return fn(*a, **k)
    monkeypatch.setattr(flash_ops, name, wrapped)
    return calls


def test_fit_losses_and_parameters_match_jax(flash_at_128, monkeypatch):
    cfg_kw = dict(hidden_size=128, intermediate_size=256, dropout=0.0)
    paddle.seed(5)
    ref = JGPT(JConfig.tiny(**cfg_kw))
    init = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig.tiny(**cfg_kw), device="cpu")
    load_reference_state(port, init)
    ids = _motif_tokens(BATCH * STEPS, 512, seed=1)

    jsched = paddle.optimizer.lr.LinearWarmup(3e-3, 2, 1e-3, 3e-3)
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, parameters=ref.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jmodel = paddle.Model(ref)
    jmodel.prepare(jopt, paddle.nn.CrossEntropyLoss())
    jrec = _JRecorder()
    jflash0 = jstat_get("STAT_flash_attention_bwd")
    jmodel.fit(paddle.io.TensorDataset([ids[:, :-1], ids[:, 1:]]),
               batch_size=BATCH, epochs=1, shuffle=False, log_freq=1,
               verbose=0, callbacks=[jrec])

    assert jstat_get("STAT_flash_attention_bwd") > jflash0  # Pallas ran
    fwd = _counting(monkeypatch, "_flash_fwd_reference")
    dq = _counting(monkeypatch, "_dq_reference")
    dkv = _counting(monkeypatch, "_dkv_reference")
    tsched = optimizer.lr.LinearWarmup(3e-3, 2, 1e-3, 3e-3)
    topt = optimizer.AdamW(learning_rate=tsched, weight_decay=0.01,
                           grad_clip=nn.ClipGradByGlobalNorm(1.0))
    tmodel = hapi.Model(port)
    tmodel.prepare(topt, nn.CrossEntropyLoss())
    trec = _TRecorder()
    syncs0 = monitor.stat_get("STAT_train_host_syncs")
    tmodel.fit(io.TensorDataset([ids[:, :-1], ids[:, 1:]]),
               batch_size=BATCH, epochs=1, shuffle=False, log_freq=1,
               verbose=0, callbacks=[trec])

    layers = port.gpt.config.num_layers
    assert fwd[0] == dq[0] == dkv[0] == layers * STEPS
    assert monitor.stat_get("STAT_train_host_syncs") - syncs0 == STEPS
    assert len(trec.losses) == len(jrec.losses) == STEPS
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=LOSS_RTOL)
    assert topt._global_step == STEPS
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in port.state_dict().items():
        if name.endswith("k_proj.bias"):
            # exactly zero gradient (a key bias shifts every score of a row
            # alike): what Adam applies there is rounding noise scaled up
            # to the size of lr, on both sides
            continue
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if name in linear else got,
                                   want[name], atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_fit_with_dropout_trains(flash_at_128, monkeypatch):
    """Dropout 0.1 on every path: attention dropout inside FlashAttention
    (its keep mask seeded from framework.random), residual and embedding
    dropout from torch's generator. The loss is finite and falls."""
    fwd = _counting(monkeypatch, "_flash_fwd_reference")
    trandom.seed(0)
    net = GPTForCausalLM(GPTConfig.tiny(hidden_size=128, dropout=0.1),
                         device="cpu")
    ids = _motif_tokens(16, 512, seed=2)
    sched = optimizer.lr.LinearWarmup(3e-3, 2, 3e-4, 3e-3)
    opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    model = hapi.Model(net).prepare(opt, nn.CrossEntropyLoss())
    rec = _TRecorder()
    model.fit(io.TensorDataset([ids[:, :-1], ids[:, 1:]]), batch_size=4,
              epochs=3, shuffle=True, log_freq=1, verbose=0,
              callbacks=[rec])
    assert fwd[0] == net.gpt.config.num_layers * 12
    assert np.all(np.isfinite(rec.losses))
    assert np.mean(rec.losses[-3:]) < rec.losses[0] - 0.5, rec.losses


def test_save_load_round_trip(tmp_path):
    trandom.seed(1)
    net = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu")
    opt = optimizer.Adam(1e-3)
    model = hapi.Model(net).prepare(opt, nn.CrossEntropyLoss())
    ids = torch.from_numpy(_motif_tokens(2, 512, seed=3)[:, :17])
    model.train_batch([ids[:, :-1]], [ids[:, 1:]])
    model.save(str(tmp_path / "ck"))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    state = {k: v.clone() for k, v in opt.state_dict().items()
             if torch.is_tensor(v)}
    model.train_batch([ids[:, :-1]], [ids[:, 1:]])
    assert opt._global_step == 2
    model.load(str(tmp_path / "ck"))
    assert opt._global_step == 1
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for k, v in opt.state_dict().items():
        if torch.is_tensor(v):
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    assert any(k.endswith("_moment1") for k in state)
    evl = model.evaluate(io.TensorDataset([ids[:, :-1].numpy(),
                                           ids[:, 1:].numpy()]),
                         batch_size=2)
    assert np.isfinite(evl["loss"])


def test_unported_options_raise():
    """Metrics and DataLoader workers are not ported and raise. AMP is
    ported: `prepare(amp_configs="O1")` returns the model and
    `train_batch` runs, its logits bfloat16 inside the step and its loss
    a finite float32 (tests/test_torch_amp.py holds it to the JAX
    package)."""
    net = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu")
    model = hapi.Model(net)
    with pytest.raises(NotImplementedError):
        model.prepare(optimizer.SGD(0.1), metrics=[object()])
    assert model.prepare(optimizer.SGD(0.1), nn.CrossEntropyLoss(),
                         amp_configs="O1") is model
    seen = []
    net.register_forward_hook(lambda m, i, out: seen.append(out.dtype))
    ids = torch.from_numpy(_motif_tokens(2, 512, seed=4)[:, :17])
    (lv,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]])
    assert seen == [torch.bfloat16]
    assert lv.dtype == torch.float32 and torch.isfinite(lv)
    with pytest.raises(NotImplementedError):
        io.DataLoader(io.TensorDataset([np.zeros((2, 3))]), num_workers=2)
