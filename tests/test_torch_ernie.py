"""paddle_tpu_torch's ERNIE/BERT family held to paddle_tpu's on bridged
weights.

A seeded `paddle_tpu` ERNIE-tiny (2 layers, hidden 128, 4 heads of 32)
is copied into the port through `load_reference_state`; numpy inputs
made from a seed, with a key-padding `attention_mask` of seeded row
lengths, go through both, float32 on the CPU, dropout 0:
- `ErnieModel`'s sequence and pooled outputs, the classifier's logits
  and `ErnieForPretraining`'s MLM and NSP logits: atol 1e-5 x max(1,
  max |ref|), rtol 1e-5;
- every parameter's gradient of a fixed random projection of those
  outputs (the JAX package's eager tape against torch autograd): within
  1e-4 x its largest |gradient| + 1e-6 x the model's largest (summation
  order only; the floor is for the key biases, whose exact gradient is
  0);
- `hapi.Model.fit` with AdamW, `CrossEntropyLoss` and
  `metric.Accuracy` over 3 epochs with no shuffle: every step's loss to
  rtol 1e-4 and every epoch's `acc` exactly, then `evaluate`'s loss and
  `acc`;
- the same fit under `amp_configs="O1"` (bfloat16) with AdamW at lr
  1e-4: each loss within `test_torch_amp.py`'s bfloat16 limit for an
  op's output, 2e-2 x max(1, |ref|) (the two packages round the logits
  to bfloat16 at other places: one ulp of a logit near 1 is 2^-7, and
  the first step's losses already differ by 3.6e-3), every epoch's
  `acc` exactly;
- the BERT configs and aliases;
- the kernel path: a `max_position_embeddings=256` ERNIE-tiny at S 256
  with FLAGS_flash_attention_min_seq 128 in both packages, the JAX side
  in interpret mode (its Pallas flash kernels), the port through
  `ops.flash_ops.flash_attention` on its plain versions (counted, and
  never `_sdpa_ref`): outputs and gradients at the limits above.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu_torch import hapi, io, metric, models, nn, optimizer
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn.functional import attention as tattention
from paddle_tpu_torch.ops import flash_ops

S = 128
B = 4
OUT_ATOL = 1e-5
OUT_RTOL = 1e-5
GRAD_SHARE = 1e-4
GRAD_FLOOR = 1e-6


def _cfg_kw(**kw):
    d = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    d.update(kw)
    return d


def _jcfg(cls=jmodels.ErnieConfig, **kw):
    cfg = cls.tiny()
    for k, v in _cfg_kw(**kw).items():
        setattr(cfg, k, v)
    return cfg


def _arrays(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _pair(name, seed=3, **kw):
    """(JAX model, port model) of class `name` with the port's weights
    copied from the JAX model's."""
    paddle.seed(seed)
    ref = getattr(jmodels, name)(_jcfg(**kw))
    port = getattr(models, name)(_jcfg(models.ErnieConfig, **kw),
                                 device="cpu")
    load_reference_state(port, _arrays(ref))
    return ref, port


def _inputs(seed=0, rows=B, seq=S, vocab=1024):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, size=(rows, seq)).astype("int64")
    tt = rng.randint(0, 2, size=(rows, seq)).astype("int64")
    lens = rng.randint(seq // 4, seq + 1, size=rows)
    lens[0] = seq
    mask = (np.arange(seq)[None] < lens[:, None]).astype("float32")
    return ids, tt, mask


def _close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=OUT_RTOL,
        atol=OUT_ATOL * max(1.0, float(np.abs(want).max())), err_msg=what)


def _outputs(ref, port, ids, tt, mask):
    jout = ref(paddle.to_tensor(ids), paddle.to_tensor(tt), None,
               paddle.to_tensor(mask))
    tout = port(torch.from_numpy(ids), torch.from_numpy(tt), None,
                torch.from_numpy(mask))
    if not isinstance(jout, (list, tuple)):
        jout, tout = [jout], [tout]
    return list(jout), list(tout)


def _projection(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(tuple(o.shape)).astype("float32")
            / np.sqrt(np.prod(o.shape)) for o in outs]


def _grads_match(ref, port, jouts, touts):
    """Backward of sum(out * w) over every output on both sides; every
    parameter's gradient held to the JAX package's."""
    ws = _projection(touts, 7)
    jl = sum((o * paddle.to_tensor(w)).sum() for o, w in zip(jouts, ws))
    jl.backward()
    tl = sum((o * torch.from_numpy(w)).sum() for o, w in zip(touts, ws))
    tl.backward()
    want = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    top = max(np.abs(g).max() for g in want.values())
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    for n, p in port.named_parameters():
        got = p.grad.numpy()
        if n in linear:
            got = got.T
        lim = GRAD_SHARE * np.abs(want[n]).max() + GRAD_FLOOR * top
        assert np.abs(got - want[n]).max() <= lim, (
            n, np.abs(got - want[n]).max(), lim)


@pytest.mark.parametrize("name", ["ErnieModel",
                                  "ErnieForSequenceClassification",
                                  "ErnieForPretraining"])
def test_outputs_and_gradients_match_jax(name):
    ref, port = _pair(name)
    ids, tt, mask = _inputs(seed=1)
    jouts, touts = _outputs(ref, port, ids, tt, mask)
    want_shapes = {"ErnieModel": [(B, S, 128), (B, 128)],
                   "ErnieForSequenceClassification": [(B, 2)],
                   "ErnieForPretraining": [(B, S, 1024), (B, 2)]}[name]
    assert [tuple(t.shape) for t in touts] == want_shapes
    for i, (j, t) in enumerate(zip(jouts, touts)):
        _close(t.detach().numpy(), np.asarray(j.numpy()), f"{name} out {i}")
    _grads_match(ref, port, jouts, touts)


def test_two_dimensional_mask_is_the_additive_mask():
    """A 2-D 1/0 mask and the additive [B,1,1,S] (1 - m) * -1e4 it
    becomes give the same output; rows past a row's length do not move
    its real positions' outputs."""
    _, port = _pair("ErnieModel")
    ids, tt, mask = _inputs(seed=2)
    with torch.no_grad():
        a, _ = port(torch.from_numpy(ids), torch.from_numpy(tt), None,
                    torch.from_numpy(mask))
        add = (1.0 - torch.from_numpy(mask)[:, None, None, :]) * -1e4
        b, _ = port(torch.from_numpy(ids), torch.from_numpy(tt), None, add)
        junk = ids.copy()
        junk[mask == 0] = 5
        c, _ = port(torch.from_numpy(junk), torch.from_numpy(tt), None,
                    torch.from_numpy(mask))
    assert torch.equal(a, b)
    real = torch.from_numpy(mask).bool()
    torch.testing.assert_close(a[real], c[real], atol=1e-5, rtol=1e-5)


def _cls_data(n=16, seed=5):
    """n rows whose label is carried by the token at position 1 (ids below
    or above the vocabulary's middle), with seeded padding."""
    ids, _, mask = _inputs(seed=seed, rows=n)
    labels = np.random.RandomState(seed + 1).randint(0, 2, n).astype("int64")
    ids[:, 1] = np.where(labels == 1, 700, 300)
    return ids, mask, labels


class _JRec(JCallback):
    def __init__(self):
        super().__init__()
        self.losses, self.epochs = [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append((float(logs["loss"]), logs["acc"]))


class _TRec(hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses, self.epochs = [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append((float(logs["loss"]), logs["acc"]))


def _fit_both(amp_level):
    ref, port = _pair("ErnieForSequenceClassification", seed=9)
    ids, mask, labels = _cls_data()
    rows = [ids, np.zeros_like(ids), np.tile(np.arange(S), (len(ids), 1)),
            mask, labels]
    specs = [None] * 4   # four network inputs: ids, types, positions, mask
    lr = 1e-3 if amp_level is None else 1e-4
    jopt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=ref.parameters(),
                                  weight_decay=0.01)
    topt = optimizer.AdamW(learning_rate=lr, weight_decay=0.01)
    jm = paddle.Model(ref, inputs=specs)
    jm.prepare(jopt, paddle.nn.CrossEntropyLoss(), JAccuracy(),
               amp_configs=amp_level)
    jm._dist_ctx = None  # another file's fleet.init may be live
    jrec = _JRec()
    jm.fit(paddle.io.TensorDataset(rows), batch_size=B, epochs=3,
           shuffle=False, log_freq=1, verbose=0, callbacks=[jrec])
    tm = hapi.Model(port, inputs=specs)
    tm.prepare(topt, nn.CrossEntropyLoss(), metric.Accuracy(),
               amp_configs=amp_level)
    trec = _TRec()
    tm.fit(io.TensorDataset(rows), batch_size=B, epochs=3, shuffle=False,
           log_freq=1, verbose=0, callbacks=[trec])
    jlogs = jm.evaluate(paddle.io.TensorDataset(rows), batch_size=B,
                        verbose=0)
    tlogs = tm.evaluate(io.TensorDataset(rows), batch_size=B, verbose=0)
    return jrec, trec, jlogs, tlogs


def _loss_close(got, want, amp_level):
    got, want = np.asarray(got), np.asarray(want)
    if amp_level is None:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:
        assert (np.abs(got - want) <= 2e-2 * np.maximum(
            1.0, np.abs(want))).all(), (got, want)


@pytest.mark.parametrize("amp_level", [None, "O1"])
def test_fit_losses_and_accuracy_match_jax(amp_level):
    jrec, trec, jlogs, tlogs = _fit_both(amp_level)
    assert len(trec.losses) == len(jrec.losses) == 12
    _loss_close(trec.losses, jrec.losses, amp_level)
    assert len(trec.epochs) == len(jrec.epochs) == 3
    for (tl, ta), (jl, ja) in zip(trec.epochs, jrec.epochs):
        _loss_close(tl, jl, amp_level)
        assert ta == ja
    assert trec.losses[-1] < trec.losses[0]
    assert set(tlogs) == set(jlogs) == {"loss", "acc"}
    _loss_close(tlogs["loss"], jlogs["loss"], amp_level)
    assert tlogs["acc"] == jlogs["acc"]


def test_bert_configs_and_aliases_match_jax():
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    for name in ("base", "large"):
        assert vars(getattr(tbert.BertConfig, name)()) == \
            vars(getattr(jbert.BertConfig, name)())
    assert vars(models.ErnieConfig.base()) == \
        vars(jmodels.ErnieConfig.base())
    assert vars(models.ErnieConfig.tiny()) == \
        vars(jmodels.ErnieConfig.tiny())
    for b, e in (("BertModel", "ErnieModel"),
                 ("BertForSequenceClassification",
                  "ErnieForSequenceClassification"),
                 ("BertForPretraining", "ErnieForPretraining")):
        assert issubclass(getattr(tbert, b), getattr(models, e))
        assert getattr(models, b) is getattr(tbert, b)
    net = models.BertModel(models.BertConfig.tiny(), device="cpu")
    assert isinstance(net.config, models.BertConfig)
    assert sorted(net.state_dict()) == sorted(
        _arrays(jbert.BertModel(jbert.BertConfig.tiny())))


def test_seeded_init_and_tp_annotate():
    """The same seed gives the same weights, another seed others; the
    initializers' laws hold (embeddings normal(0, 0.02), Linear weights
    within the Xavier limit, zero biases, unit LayerNorms);
    `tp_annotate` with no mesh marks the JAX package's parameters (by
    name) and leaves the weights and the forward as they were."""
    cfg = models.ErnieConfig.tiny()
    a = models.ErnieForPretraining(cfg, device="cpu", seed=4).state_dict()
    b = models.ErnieForPretraining(cfg, device="cpu", seed=4).state_dict()
    c = models.ErnieForPretraining(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "ernie.encoder.layers.1.linear1.weight"
    assert not torch.equal(a[w], c[w])
    assert not torch.equal(a[w], a["ernie.encoder.layers.0.linear1.weight"])
    emb = a["ernie.embeddings.word_embeddings.weight"]
    assert abs(float(emb.std()) - 0.02) < 3 * 0.02 / np.sqrt(2 * emb.numel())
    lim = np.sqrt(6.0 / (128 + 256))
    assert float(a[w].abs().max()) <= lim
    assert float(a["ernie.encoder.layers.1.linear1.bias"].abs().max()) == 0
    assert float(a["mlm_bias"].abs().max()) == 0
    assert torch.equal(a["mlm_norm.weight"], torch.ones(128))
    net = models.ErnieForPretraining(cfg, device="cpu", seed=4).eval()
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 1024,
                                                            (2, 16)))
    before = [t.detach().clone() for t in net(ids)]
    assert models.tp_annotate(net) is net
    marked = {n for n, p in net.named_parameters()
              if getattr(p, "partition_spec", None)}
    jnet = jmodels.tp_annotate(jmodels.ErnieForPretraining(cfg))
    want = {n for n, p in jnet.named_parameters()
            if getattr(p, "partition_spec", None)}
    assert marked == want and len(marked) == 10 * cfg.num_hidden_layers + 1
    assert all(torch.equal(net.state_dict()[k], a[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(net(ids), before))


@pytest.fixture
def flash_at_128():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_use_flash_attention",
                     "FLAGS_flash_attention_min_seq"])
    old_t = tflags.get_flags(["FLAGS_use_flash_attention",
                              "FLAGS_flash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_interpret": True,
               "FLAGS_use_flash_attention": True,
               "FLAGS_flash_attention_min_seq": 128})
    tflags.set_flags({"FLAGS_use_flash_attention": True,
                      "FLAGS_flash_attention_min_seq": 128})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _counting(monkeypatch, module, name):
    calls = [0]
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[0] += 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("name", ["ErnieForSequenceClassification",
                                  "ErnieForPretraining"])
def test_flash_path_matches_jax_interpret(name, flash_at_128, monkeypatch):
    """S 256 with a key-padding mask: both packages take flash attention
    (the JAX Pallas kernels in interpret mode; the port's FlashAttention,
    whose wrappers run their plain versions on CPU tensors), once a layer
    forward and once a layer backward, and never the dense path."""
    seq = 256
    ref, port = _pair(name, max_position_embeddings=seq)
    ids, tt, mask = _inputs(seed=4, rows=2, seq=seq)
    fwd = _counting(monkeypatch, flash_ops, "_flash_fwd_reference")
    dq = _counting(monkeypatch, flash_ops, "_dq_reference")
    dkv = _counting(monkeypatch, flash_ops, "_dkv_reference")
    dense = _counting(monkeypatch, tattention, "_sdpa_ref")
    from paddle_tpu.framework.monitor import stat_get as jstat
    j0 = jstat("STAT_flash_attention_fwd")
    jouts, touts = _outputs(ref, port, ids, tt, mask)
    assert jstat("STAT_flash_attention_fwd") > j0   # Pallas ran
    for i, (j, t) in enumerate(zip(jouts, touts)):
        _close(t.detach().numpy(), np.asarray(j.numpy()), f"{name} out {i}")
    _grads_match(ref, port, jouts, touts)
    layers = port.ernie.config.num_hidden_layers
    assert (fwd[0], dq[0], dkv[0], dense[0]) == (layers, layers, layers, 0)
