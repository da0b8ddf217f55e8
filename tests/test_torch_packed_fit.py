"""The packing slice as a whole: paddle_tpu_torch's packed training held
to paddle_tpu's on the same packed LM, weights and packs.

The packed LM of tests/test_packing.py:51-73 (embedding + position
embedding + one causal-within-segment attention block + LM head), at
T = 128 with 2 heads of 32 and FLAGS_splash_attention_min_seq = 128 on
both sides, so every attention call takes splash attention: the JAX side
runs its Pallas kernels in interpret mode, the port `SplashAttention` on
its plain versions (CPU tensors). Weights cross by
`models.load_reference_state`. Tolerances: losses 5e-4 absolute (a
float32 cross-entropy over 64 classes summed in other orders), fit's
per-step losses rtol 1e-4 (as tests/test_torch_hapi_fit.py), packed vs
padded 1e-3 (the JAX package's own bound)."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.framework.monitor import stat_get as jstat_get
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.io import DataLoader as JDataLoader
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.io import PackingCollator as JCollator
from paddle_tpu.static.input_spec import InputSpec as JInputSpec
from paddle_tpu_torch import hapi, io, nn, optimizer
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _build, splash_ops
from paddle_tpu_torch.static import InputSpec

VOCAB, DIM, HEADS, T = 64, 64, 2, 128
LOSS_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _splash_at_128():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_use_splash_attention",
                     "FLAGS_splash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_interpret": True,
               "FLAGS_use_splash_attention": True,
               "FLAGS_splash_attention_min_seq": T})
    old_t = tflags.get_flags(["FLAGS_splash_attention_min_seq"])
    tflags.set_flags({"FLAGS_splash_attention_min_seq": T})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _seqs(n, seed, lo=4, hi=T):
    rng = np.random.RandomState(seed)
    lengths = np.clip(np.round(np.exp(rng.normal(3.0, 0.8, n))).astype(int),
                      lo, hi)
    return [(rng.randint(0, VOCAB, (L,)).astype("int64"),
             rng.randint(0, VOCAB, (L,)).astype("int64"))
            for L in lengths]


class JPackedLM(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(VOCAB, DIM)
        self.pos = jnn.Embedding(T, DIM)
        self.qkv = jnn.Linear(DIM, 3 * DIM)
        self.head = jnn.Linear(DIM, VOCAB)

    def forward(self, toks, seg, pos):
        x = self.emb(toks) + self.pos(pos)
        B, S = toks.shape[0], toks.shape[1]
        qkv = self.qkv(x).reshape([B, S, 3, HEADS, DIM // HEADS]).transpose(
            [2, 0, 3, 1, 4])
        o = JF.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                            is_causal=True, segment_ids=seg)
        x = x + o.transpose([0, 2, 1, 3]).reshape([B, S, DIM])
        return self.head(x)


class TPackedLM(torch.nn.Module):
    """The same network in PyTorch, with the JAX layer's names."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(VOCAB, DIM)
        self.pos = torch.nn.Embedding(T, DIM)
        self.qkv = torch.nn.Linear(DIM, 3 * DIM)
        self.head = torch.nn.Linear(DIM, VOCAB)

    def forward(self, toks, seg, pos):
        x = self.emb(toks) + self.pos(pos)
        B, S = toks.shape
        qkv = self.qkv(x).reshape(B, S, 3, HEADS, DIM // HEADS).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                           is_causal=True, segment_ids=seg)
        return self.head(x + o.transpose(1, 2).reshape(B, S, DIM))


class SeqData(io.Dataset):
    def __init__(self, seqs):
        self.seqs = seqs

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, i):
        return self.seqs[i]


class JSeqData(JDataset):
    def __init__(self, seqs):
        self.seqs = seqs

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, i):
        return self.seqs[i]


def _models(seed, lr=0.01):
    """(jax Model, port Model), same initial weights, Adam(lr), CE."""
    paddle.seed(seed)
    jnet = JPackedLM()
    jm = paddle.Model(jnet, inputs=[JInputSpec([None, T], "int64", "toks"),
                                    JInputSpec([None, T], "int32", "seg"),
                                    JInputSpec([None, T], "int32", "pos")],
                      labels=[JInputSpec([None, T], "int64", "labels")])
    jm.prepare(paddle.optimizer.Adam(lr, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss())
    jm._dist_ctx = None
    tnet = TPackedLM()
    load_reference_state(tnet, {k: np.asarray(v.numpy())
                                for k, v in jnet.state_dict().items()})
    tm = hapi.Model(tnet, inputs=[InputSpec([None, T], "int64", "toks"),
                                  InputSpec([None, T], "int32", "seg"),
                                  InputSpec([None, T], "int32", "pos")],
                    labels=[InputSpec([None, T], "int64", "labels")])
    tm.prepare(optimizer.Adam(lr), nn.CrossEntropyLoss())
    return jm, tm


def _manual_masked_ce(model, pack):
    """Token-masked cross-entropy by hand from the model's own logits."""
    toks, seg, pos, labels, mask = pack
    logits = model.predict_batch([toks, seg, pos]).astype("float64")
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    return float((nll * mask).sum() / mask.sum())


def test_packed_eval_batch_matches_jax_and_hand_ce():
    seqs = _seqs(10, seed=1)
    pack = io.PackingCollator(T, 4)(seqs)
    jm, tm = _models(seed=2)
    n0 = monitor.stat_get("STAT_splash_dispatches")
    got, _ = tm.eval_batch(list(pack[:3]), [pack[3]], loss_mask=pack[4])
    assert monitor.stat_get("STAT_splash_dispatches") == n0 + 1
    want, _ = jm.eval_batch(list(pack[:3]), [pack[3]], loss_mask=pack[4])
    assert abs(float(got) - float(want)) < LOSS_ATOL
    assert abs(float(got) - _manual_masked_ce(tm, pack)) < LOSS_ATOL


class _JRec(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


class _TRec(hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


def test_fit_two_epochs_matches_jax():
    """2-epoch packed Adam fit over a set whose last pack is partial: the
    per-step losses agree to rtol 1e-4, no row is padded on either side,
    nothing is dropped, and every step went through splash attention."""
    seqs = _seqs(26, seed=3)           # 26 sequences, 8 a pack: 3 + tail 2
    rows = io.suggest_rows([len(s[0]) for s in seqs], 8, T, headroom=1.6)
    jm, tm = _models(seed=4)
    jrec, trec = _JRec(), _TRec()
    tp0 = (monitor.stat_get("STAT_tail_pad_batches"),
           jstat_get("STAT_tail_pad_batches"))
    d0 = monitor.stat_get("STAT_packing_dropped_seqs")
    j0 = jstat_get("STAT_splash_dispatches")
    jm.fit(JDataLoader(JSeqData(seqs), batch_size=8, shuffle=False,
                       collate_fn=JCollator(T, rows)),
           epochs=2, verbose=0, log_freq=1, callbacks=[jrec])
    assert jstat_get("STAT_splash_dispatches") > j0    # Pallas splash ran
    n0 = monitor.stat_get("STAT_splash_dispatches")
    tm.fit(io.DataLoader(SeqData(seqs), batch_size=8, shuffle=False,
                         collate_fn=io.PackingCollator(T, rows)),
           epochs=2, verbose=0, log_freq=1, callbacks=[trec])
    assert monitor.stat_get("STAT_splash_dispatches") == n0 + 8
    assert (monitor.stat_get("STAT_tail_pad_batches"),
            jstat_get("STAT_tail_pad_batches")) == tp0
    assert monitor.stat_get("STAT_packing_dropped_seqs") == d0
    assert len(trec.losses) == len(jrec.losses) == 8
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-4)
    assert np.isfinite(tm.network.head.weight.detach().numpy()).all()


def test_evaluate_weights_packs_by_real_tokens():
    seqs = _seqs(16, seed=5)
    rows = io.suggest_rows([len(s[0]) for s in seqs], 8, T, headroom=1.6)
    jm, tm = _models(seed=6)
    coll = io.PackingCollator(T, rows)
    logs = tm.evaluate(io.DataLoader(SeqData(seqs), batch_size=8,
                                     collate_fn=coll))
    packs = [coll(seqs[i:i + 8]) for i in (0, 8)]
    per = [_manual_masked_ce(tm, p) for p in packs]
    wts = [float(p[4].sum()) for p in packs]
    assert wts[0] != wts[1]            # the weighting must matter
    assert abs(logs["loss"] - np.average(per, weights=wts)) < LOSS_ATOL
    assert abs(np.average(per, weights=wts) - np.mean(per)) > 1e-6
    jlogs = jm.evaluate(JDataLoader(JSeqData(seqs), batch_size=8,
                                    collate_fn=JCollator(T, rows)),
                        verbose=0)
    assert abs(logs["loss"] - jlogs["loss"]) < LOSS_ATOL


def test_packed_vs_padded_parity():
    """The same sequences as one pack and as a padded batch (one sequence
    a row), same weights: the token-normalised losses agree within
    1e-3."""
    seqs = _seqs(6, seed=7)
    packed = io.PackingCollator(T, io.suggest_rows(
        [len(s[0]) for s in seqs], 6, T, headroom=2.0))(seqs)
    padded = io.PackingCollator(T, len(seqs), policy="pad")(seqs)
    assert float(packed[4].sum()) == float(padded[4].sum())   # no drops
    _, tm = _models(seed=8)
    la, _ = tm.eval_batch(list(packed[:3]), [packed[3]], loss_mask=packed[4])
    lb, _ = tm.eval_batch(list(padded[:3]), [padded[3]], loss_mask=padded[4])
    assert abs(float(la) - float(lb)) < 1e-3


def test_predict_does_not_row_pad():
    seqs = _seqs(10, seed=9)
    jm, tm = _models(seed=10)
    tp0 = monitor.stat_get("STAT_tail_pad_batches")
    outs = tm.predict(io.DataLoader(SeqData(seqs), batch_size=5,
                                    collate_fn=io.PackingCollator(T, 4)))
    assert monitor.stat_get("STAT_tail_pad_batches") == tp0
    assert len(outs) == 2 and outs[0].shape == (4, T, VOCAB)
    want = jm.predict(JDataLoader(JSeqData(seqs), batch_size=5,
                                  collate_fn=JCollator(T, 4)))
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=LOSS_ATOL,
                                   rtol=0)
    stacked = tm.predict(io.DataLoader(SeqData(seqs), batch_size=5,
                                       collate_fn=io.PackingCollator(T, 4)),
                         stack_outputs=True)
    assert stacked.shape == (8, T, VOCAB)


def test_token_mask_scalar_loss_raises():
    """Packing needs a per-token loss: one that only gives a scalar
    raises TypeError, never trains on pad tokens."""
    pack = io.PackingCollator(T, 3)(_seqs(6, seed=11))
    _, tm = _models(seed=12)
    tm._loss = lambda out, lb: (out.reshape(-1, VOCAB) ** 2).mean()
    with pytest.raises(TypeError, match="per-token"):
        tm.train_batch(list(pack[:3]), [pack[3]], loss_mask=pack[4])
    assert all(p.grad is None for p in tm.network.parameters())


def test_row_mask_path():
    """A 1-D row mask: the loss of the real rows only, as the JAX
    package's; a loss without per-row values falls back to the real rows
    with one warning, as there."""
    x = np.random.RandomState(0).randn(8, 4).astype("float32")
    y = np.random.RandomState(1).randint(0, 3, (8,)).astype("int64")
    paddle.seed(12)
    jnet = jnn.Sequential(jnn.Linear(4, 3))
    jm = paddle.Model(jnet)
    jm.prepare(paddle.optimizer.Adam(0.01, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss())
    jm._dist_ctx = None
    tnet = torch.nn.Sequential(torch.nn.Linear(4, 3))
    load_reference_state(tnet, {k: np.asarray(v.numpy())
                                for k, v in jnet.state_dict().items()})
    tm = hapi.Model(tnet).prepare(optimizer.Adam(0.01),
                                  nn.CrossEntropyLoss())
    mask = np.ones((8,), "float32")
    mask[6:] = 0.0
    lv, _ = tm.eval_batch([x], [y], loss_mask=mask)
    lv_ref, _ = tm.eval_batch([x[:6]], [y[:6]])
    np.testing.assert_allclose(float(lv), float(lv_ref), rtol=1e-6)
    jlv, _ = jm.eval_batch([x], [y], loss_mask=mask)
    np.testing.assert_allclose(float(lv), float(jlv), rtol=1e-5)
    lv_sum = hapi.Model(tnet).prepare(
        optimizer.Adam(0.01), nn.CrossEntropyLoss(reduction="sum")
    ).eval_batch([x], [y], loss_mask=mask)[0]
    np.testing.assert_allclose(float(lv_sum), 6 * float(lv_ref), rtol=1e-5)
    # a loss with no per-row values cannot take the mask: as in the JAX
    # package, the model warns once and runs the real rows unmasked
    # (tests/test_torch_tail_bucketing.py holds the fallback in fit to
    # the JAX package's)
    tm._loss = lambda out, lb: out.sum()
    with pytest.warns(UserWarning, match="per-row"):
        lv_fb, _ = tm.eval_batch([x], [y], loss_mask=mask)
    with torch.no_grad():
        want = float(tnet(torch.from_numpy(x[:6])).sum())
    np.testing.assert_allclose(float(lv_fb), want, rtol=1e-5)
    assert tm._tail_maskable is False


def test_splash_wrappers_on_cpu_build_nothing():
    """The K5-K7 wrappers on CPU tensors take their plain versions: no
    launch counted, nothing built, and the results are SplashAttention's
    gradients."""
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2, 128, 32))
                                    .astype(np.float32)) for _ in range(4))
    seg = torch.from_numpy(np.repeat([[0] * 50 + [1] * 78], 2, 0)
                           .astype(np.int32))
    out, lse = splash_ops.splash_attention_fwd(q, k, v, seg, seg, True, 0.2,
                                               0.1, 5)
    delta = (out * do).sum(-1).reshape(4, 128)
    args = (q, k, v, seg, seg, do, lse, delta, True, 0.2, 0.1, 5)
    dq = splash_ops.splash_attention_dq(*args)
    dk, dv = splash_ops.splash_attention_dkv(*args)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = torch.autograd.grad(splash_ops.splash_attention(
            *ins, seg, seg, causal=True, scale=0.2, dropout_p=0.1,
            generator=torch.Generator().manual_seed(3)), ins, do)
    assert all(g.shape == q.shape for g in (dq, dk, dv, *got))
    assert splash_ops.splash_attention_fwd.launches == 0
    assert splash_ops.splash_attention_dq.launches == 0
    assert splash_ops.splash_attention_dkv.launches == 0
    assert monitor.stat_get("STAT_splash_attention_fwd") == 0
    assert _build._libs == {}
