"""The attention LSTM seq2seq (`models.seq2seq`), built by one function
from each package's public API at a small size (vocab 40 / 30, hidden
32, 2 layers, batch 4, source lengths 3-9, dropout 0), the port's weights
carried from the JAX model by `load_reference_state`:

- logits and the masked loss within 1e-5 x max(1, |ref|);
- every parameter's gradient within 1e-4 x its largest + 1e-6 x the
  model's largest (the JAX model through its functional capture under
  one `jax.jit(jax.value_and_grad)`);
- three `fit` steps of Adam under `ClipGradByGlobalNorm` give the same
  losses (rtol 1e-4);
- beam search (beam 3, 6 steps) gives the same token ids, the scores
  within 1e-5.
"""
import functools

import jax
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.functional import functionalize
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.models.seq2seq import (reversal_batch, seq2seq_attn,
                                             seq2seq_criterion)
from torch_ops_parity import QUICK, on_the_cpu  # noqa: F401

SIZE = dict(src_vocab=40, trg_vocab=30, hidden=32, num_layers=2,
            dropout=0.0, init_scale=0.3)


@functools.lru_cache(maxsize=None)
def _ref():
    """The JAX model and its weights as numpy."""
    paddle.seed(5)
    net = seq2seq_attn(paddle, **SIZE)
    return net, {k: np.asarray(v.numpy())
                 for k, v in net.state_dict().items()}


def _pair(fresh=False):
    """The JAX model (a new one carrying the same weights when `fresh`,
    for a test that trains it) and the port's carrying its weights."""
    ref, state = _ref()
    if fresh:
        ref = seq2seq_attn(paddle, **SIZE)
        ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = seq2seq_attn(ptt, **SIZE)
    load_reference_state(port, state)
    return ref, port


def _batch(seed, rows=4):
    return reversal_batch(np.random.RandomState(seed), rows,
                          SIZE["src_vocab"], SIZE["trg_vocab"], 3, 9)


def _jax_step(ref, batch):
    """(logits, loss, {param: gradient}) of the JAX model, jitted."""
    crit = seq2seq_criterion(paddle)
    apply_fn, pv, bv = functionalize(
        ref, lambda s, sl, ti, to, tl: (lambda lg: (lg, crit(lg, to, tl)))(
            ref(s, sl, ti)))

    def loss(pv):
        (logits, lv), _ = apply_fn(pv, bv, jax.random.PRNGKey(0), True,
                                   *batch)
        return lv, logits

    (lv, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True),
                              compiler_options=QUICK)(pv)
    return (np.asarray(logits), float(lv),
            {k: np.asarray(v) for k, v in g.items()})


def test_logits_loss_and_gradients_match_jax():
    ref, port = _pair()
    assert sorted(port.state_dict()) == sorted(_ref()[1])
    batch = _batch(0)
    src, sl, tin, tout, tl = batch
    want, jloss, jgrads = _jax_step(ref, batch)
    tlog = port(*[torch.from_numpy(a) for a in (src, sl, tin)])
    tloss = seq2seq_criterion()(tlog, torch.from_numpy(tout),
                                torch.from_numpy(tl))
    np.testing.assert_allclose(tlog.detach().numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    tloss.backward()
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    floor = 1e-6 * max(np.abs(g).max() for g in jgrads.values())
    for name, p in port.named_parameters():
        got = p.grad.numpy()
        got = got.T if name in linear else got
        want = jgrads[name]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)


def _recorder(P):
    class Losses(P.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
    return Losses()


def _fit(P, net, arrays):
    rec = _recorder(P)
    spec = P.static.InputSpec
    model = P.Model(net, inputs=[spec([None, None], "int32")] * 3,
                    labels=[spec([None, None], "int32")] * 2)
    kw = {"parameters": net.parameters()} if P is paddle else {}
    model.prepare(P.optimizer.Adam(1e-2, grad_clip=P.nn.ClipGradByGlobalNorm(
        0.5), **kw), seq2seq_criterion(P))
    model.fit(P.io.TensorDataset(list(arrays)), batch_size=4, epochs=1,
              shuffle=False, log_freq=1, verbose=0, callbacks=[rec])
    return rec.losses


def test_fit_losses_match_jax():
    ref, port = _pair(fresh=True)
    arrays = _batch(1, rows=12)
    want = _fit(paddle, ref, arrays)
    got = _fit(ptt, port, arrays)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_beam_search_matches_jax():
    ref, port = _pair()
    src, sl = _batch(2)[:2]
    jids, jsc = ref.beam_search(paddle.to_tensor(src), paddle.to_tensor(sl),
                                beam_size=3, max_step_num=6)
    tids, tsc = port.beam_search(torch.from_numpy(src), torch.from_numpy(sl),
                                 beam_size=3, max_step_num=6)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids.numpy()))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc.numpy()),
                               rtol=0, atol=1e-5)
    assert (np.diff(tsc.numpy(), axis=1) <= 0).all()
