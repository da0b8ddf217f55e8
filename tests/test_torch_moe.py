"""GPT's mixture-of-experts feed-forward: paddle_tpu_torch held to
paddle_tpu on a tiny MoE GPT (`GPTConfig.tiny(use_moe=True,
num_experts=4)`, dropout 0) whose weights the port takes through
`load_reference_state` (only the gate, a Linear, is transposed).

- The routing: the argmax expert of every token in every block, from
  the gate's softmax on each block's own input. The two packages may
  route a token differently only where the JAX package's top-2 gate
  probabilities are closer than NEAR_TIE (a hard argmax flips on
  rounding there, ROADMAP C2); logits are then compared only where no
  earlier token of the row flipped.
- fp32: the logits within 1e-5 x max(1, max |logit|), every parameter's
  gradient (gate and experts included) within 1e-4 x max(1, max |grad|),
  three `fit` losses (AdamW) to rtol 1e-4.
- O1 (bfloat16): one train_batch's loss to rtol 1e-3 and gradients
  within 5e-2 x their largest + 2e-3 x the model's largest, and three
  `fit` losses to rtol 1e-3 (tests/test_torch_amp.py's GPT O1 limits);
  the expert products run in float32 in both (ROADMAP C19).
- `generate()` raises in both packages.
- GELU is the tanh approximation: the JAX layer's output matches a
  numpy MoE with the tanh GELU and misses one with the exact GELU by
  more than the tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import MoEFeedForward as JMoE
from paddle_tpu_torch import hapi, io, nn, optimizer
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.models.gpt import MoEFeedForward

E = 4
S = 32
NEAR_TIE = 1e-2
CFG = dict(use_moe=True, num_experts=E, dropout=0.0)


@functools.lru_cache(maxsize=None)
def _ref_state(seed):
    paddle.seed(seed)
    ref = JGPT(JConfig.tiny(**CFG))
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _pair(seed=3):
    """A JAX and a port MoE GPT with the same weights."""
    state = _ref_state(seed)
    ref = JGPT(JConfig.tiny(**CFG))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = GPTForCausalLM(GPTConfig.tiny(**CFG), device="cpu")
    load_reference_state(port, state)
    return ref, port


def _ids(seed, rows=2):
    return np.random.RandomState(seed).randint(0, 512, (rows, S + 1))


def _record_jax_inputs(monkeypatch):
    seen = []
    orig = JMoE.forward

    def forward(self, x):
        seen.append((np.asarray(x.numpy().astype(np.float32)),
                     np.asarray(self.gate.weight.numpy()),
                     np.asarray(self.gate.bias.numpy())))
        return orig(self, x)
    monkeypatch.setattr(JMoE, "forward", forward)
    return seen


def _record_port_inputs(port):
    seen = []
    for blk in port.gpt.blocks:
        blk.mlp.register_forward_hook(
            lambda m, i, o: seen.append((i[0].detach().float(), m)))
    return seen


def _jax_routing(h, gw, gb, dtype):
    """The JAX layer's routing expression on its own input."""
    hh = jnp.asarray(h).astype(dtype)
    probs = jax.nn.softmax(hh @ jnp.asarray(gw) + jnp.asarray(gb), axis=-1)
    probs = np.asarray(probs, np.float32)
    top2 = np.sort(probs, -1)[..., -2:]
    return probs.argmax(-1), top2[..., 1] - top2[..., 0]


def _port_routing(h, mod, dtype):
    with torch.no_grad():
        probs = torch.softmax(torch.nn.functional.linear(
            h.to(dtype).float(), mod.gate.weight, mod.gate.bias), -1)
    return probs.argmax(-1).numpy()


def _routing(jseen, tseen, dtype):
    """[blocks, B, S] bool of flipped tokens; asserts every flip is a
    near-tie of the JAX package's gate."""
    flips = []
    for (h, gw, gb), (th, mod) in zip(jseen, tseen):
        jr, gap = _jax_routing(h, gw, gb, jnp.dtype(dtype))
        tr = _port_routing(th, mod, getattr(torch, dtype))
        flip = jr != tr
        assert np.all(gap[flip] < NEAR_TIE), gap[flip]
        flips.append(flip)
    assert len(flips) == 2
    return np.stack(flips)


def _unflipped(flips):
    """[B, S] True where no token at or before this one in its row was
    routed differently in any block (causal attention spreads a flip
    forward)."""
    any_flip = flips.any(0)
    return np.cumsum(any_flip, axis=1) == 0


def test_routing_and_logits_match_jax(monkeypatch):
    ref, port = _pair()
    ids = _ids(0)[:, :-1]
    jseen = _record_jax_inputs(monkeypatch)
    tseen = _record_port_inputs(port)
    want = np.asarray(ref(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    flips = _routing(jseen, tseen, "float32")
    assert not flips.any()
    # the routing spreads over the experts (so every expert is exercised)
    assert len(np.unique(_jax_routing(*jseen[0], jnp.float32)[0])) > 1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _loss_fn_j(logits, labels):
    return paddle.nn.functional.cross_entropy(logits, labels)


def test_gradients_match_jax():
    """Every parameter's gradient of a cross-entropy step, fp32 (the JAX
    eager tape)."""
    ref, port = _pair()
    ids = _ids(1)
    jl = _loss_fn_j(ref(paddle.to_tensor(ids[:, :-1])),
                    paddle.to_tensor(ids[:, 1:]))
    jl.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in ref.named_parameters()}
    loss = nn.CrossEntropyLoss()(port(torch.from_numpy(ids[:, :-1])),
                                 torch.from_numpy(ids[:, 1:]))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl.numpy()), rtol=1e-5)
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    names = dict(port.named_parameters())
    assert {n for n in names if ".mlp." in n} == {
        f"gpt.blocks.{i}.mlp.{k}" for i in range(2)
        for k in ("gate.weight", "gate.bias", "w_up", "w_down")}
    for name, p in names.items():
        got = p.grad.numpy()
        got = got.T if name in linear else got
        want = jgrads[name]
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()),
            err_msg=name)
    for i in range(2):   # the experts and the gate do learn
        assert np.abs(names[f"gpt.blocks.{i}.mlp.w_up"].grad.numpy()).max() > 0
        assert np.abs(names[f"gpt.blocks.{i}.mlp.gate.weight"].grad.numpy()
                      ).max() > 0


class _JRec(paddle.hapi.callbacks.Callback):
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


@pytest.mark.parametrize("amp_level,rtol", [(None, 1e-4), ("O1", 1e-3)])
def test_fit_losses_match_jax(amp_level, rtol):
    """Three AdamW fit steps from the same weights on the same batches;
    under O1 the first step's routing is compared too."""
    ref, port = _pair()
    ids = np.concatenate([_ids(s) for s in (2, 3, 4)])
    tseen = _record_port_inputs(port)
    jopt = paddle.optimizer.AdamW(1e-3, parameters=ref.parameters(),
                                  weight_decay=0.01)
    jm = paddle.Model(ref)
    jm.prepare(jopt, paddle.nn.CrossEntropyLoss(), amp_configs=amp_level)
    jm._dist_ctx = None  # another file's fleet.init may be live
    jrec = _JRec()
    jm.fit(paddle.io.TensorDataset([ids[:, :-1], ids[:, 1:]]), batch_size=2,
           epochs=1, shuffle=False, log_freq=1, verbose=0, callbacks=[jrec])
    tm = hapi.Model(port).prepare(
        optimizer.AdamW(1e-3, weight_decay=0.01), nn.CrossEntropyLoss(),
        amp_configs=amp_level)
    trec = _TRec()
    tm.fit(io.TensorDataset([ids[:, :-1], ids[:, 1:]]), batch_size=2,
           epochs=1, shuffle=False, log_freq=1, verbose=0, callbacks=[trec])
    assert len(jrec.losses) == len(trec.losses) == 3
    if amp_level == "O1":
        # the JAX fit runs its step traced, so its layer inputs cannot be
        # read: hold the port's first step's routing to the JAX layer's
        # expression on the port's bf16 input
        for th, mod in tseen[:2]:
            hb = th.to(torch.bfloat16).float().numpy()
            jr, gap = _jax_routing(hb, mod.gate.weight.detach().numpy().T,
                                   mod.gate.bias.detach().numpy(),
                                   jnp.bfloat16)
            tr = _port_routing(th, mod, torch.bfloat16)
            assert np.all(gap[jr != tr] < NEAR_TIE)
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=rtol)


def _jax_grads_o1(ref, ids):
    """Loss and gradients of one JAX O1 train_batch: SGD at lr 1 makes
    p_before - p_after the gradient."""
    before = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.SGD(1.0, parameters=ref.parameters()),
               paddle.nn.CrossEntropyLoss(), amp_configs="O1")
    jm._dist_ctx = None  # another file's fleet.init may be live
    loss = float(np.asarray(jm.train_batch([ids[:, :-1]],
                                           [ids[:, 1:]])[0][0]))
    jm._sync_carry()
    after = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    return loss, {k: before[k] - after[k] for k in before}


def test_train_batch_under_o1_matches_jax(monkeypatch):
    """One O1 train_batch: the routing on bf16 block inputs (JAX eager
    forward under auto_cast), the loss, every gradient."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    ref, port = _pair()
    ids = _ids(5)
    jseen = _record_jax_inputs(monkeypatch)
    tseen = _record_port_inputs(port)
    with jamp.auto_cast(level="O1"):
        jlog = ref(paddle.to_tensor(ids[:, :-1]))
    with torch.no_grad(), tamp.auto_cast(level="O1"):
        tlog = port(torch.from_numpy(ids[:, :-1]))
    flips = _routing(jseen, tseen, "bfloat16")
    keep = _unflipped(flips)
    want = np.asarray(jlog.numpy().astype(np.float32))
    np.testing.assert_allclose(tlog.float().numpy()[keep], want[keep],
                               rtol=0, atol=2e-2 * np.abs(want).max())
    monkeypatch.undo()
    jloss, jgrads = _jax_grads_o1(ref, ids)
    model = hapi.Model(port).prepare(optimizer.SGD(1.0),
                                     nn.CrossEntropyLoss(),
                                     amp_configs="O1")
    (lv,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]], update=False)
    np.testing.assert_allclose(float(lv), jloss, rtol=1e-3)
    top = max(np.abs(g).max() for g in jgrads.values())
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in port.named_parameters():
        got = p.grad.numpy()
        got = got.T if name in linear else got
        want = jgrads[name]
        lim = 5e-2 * np.abs(want).max() + 2e-3 * top
        assert np.abs(got - want).max() <= lim, (
            name, np.abs(got - want).max(), lim)


def test_expert_products_run_in_float32_under_o1():
    """ROADMAP C19: `moe_ffn` is in neither AMP list, so under O1 the
    bfloat16 LN output meets float32 experts and the layer's output is
    float32 in both packages."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    ref, port = _pair()
    h = np.random.RandomState(6).standard_normal((2, 8, 64)).astype(
        np.float32)
    jmlp, tmlp = ref.gpt.blocks[0].mlp, port.gpt.blocks[0].mlp
    with jamp.auto_cast(level="O1"):
        jo = jmlp(paddle.to_tensor(h).astype("bfloat16"))
    with torch.no_grad(), tamp.auto_cast(level="O1"):
        to = tmlp(torch.from_numpy(h).to(torch.bfloat16))
    assert np.asarray(jo.numpy()).dtype == np.float32
    assert to.dtype == torch.float32
    want = np.asarray(jo.numpy())
    np.testing.assert_allclose(to.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    with torch.no_grad(), tamp.auto_cast(level="O1",
                                         custom_white_list={"moe_ffn"}):
        # a custom white entry casts the experts to bf16: the products
        # then run in bf16, as the JAX package's would
        assert tmlp(torch.from_numpy(h).to(torch.bfloat16)).dtype == \
            torch.bfloat16


def test_generate_raises_in_both():
    ref, port = _pair()
    ids = _ids(7)[:, :4]
    with pytest.raises(NotImplementedError):
        ref.generate(paddle.to_tensor(ids), max_new_tokens=2)
    with pytest.raises(NotImplementedError):
        port.generate(ids, max_new_tokens=2)


def _gelu(x, tanh):
    if tanh:
        return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (x + 0.044715 * x ** 3)))
    from scipy.special import erf
    return 0.5 * x * (1 + erf(x / np.sqrt(2)))


def _moe_numpy(h, gw, gb, wu, wd, tanh):
    """The layer in float64 numpy, gw [d, E] (the JAX layout)."""
    h = h.astype(np.float64)
    logits = h @ gw + gb
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    onehot = np.eye(gw.shape[1])[probs.argmax(-1)]
    g = (probs * onehot).sum(-1, keepdims=True)
    up = np.einsum("bse,bsd,edf->bsef", onehot, h, wu)
    return np.einsum("bsef,efd->bsd", _gelu(up, tanh), wd) * g


@pytest.mark.parametrize("tanh", [True, False])
def test_gelu_is_the_tanh_approximation(tanh):
    """The JAX layer and the port's agree within 1e-5 x max |out|, and
    so does a float64 numpy MoE with the tanh GELU; one with the exact
    GELU misses by more than ten times that, so a port using it would
    fail this parity."""
    ref, port = _pair()
    h = 3.0 * np.random.RandomState(8).standard_normal((2, 8, 64)).astype(
        np.float32)
    jmlp = ref.gpt.blocks[0].mlp
    want = np.asarray(jmlp(paddle.to_tensor(h)).numpy())
    with torch.no_grad():
        got = port.gpt.blocks[0].mlp(torch.from_numpy(h)).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    npy = _moe_numpy(h, np.asarray(jmlp.gate.weight.numpy()),
                     np.asarray(jmlp.gate.bias.numpy()),
                     np.asarray(jmlp.w_up.numpy()),
                     np.asarray(jmlp.w_down.numpy()), tanh)
    err = np.abs(npy - want).max()
    if tanh:
        assert err <= tol, (err, tol)
    else:
        assert err > 10 * tol, (err, tol)


def test_moe_layer_standalone_and_parameters():
    """`MoEFeedForward` alone: shapes, Xavier-uniform experts under the
    JAX fan rule (fan_in d*f, fan_out E*f), a Linear gate with a bias."""
    m = MoEFeedForward(64, 128, E, device="cpu")
    limit = np.sqrt(6.0 / (64 * 128 + E * 128))
    assert tuple(m.w_up.shape) == (E, 64, 128)
    assert tuple(m.w_down.shape) == (E, 128, 64)
    assert float(m.w_up.abs().max()) <= limit
    assert float(m.w_up.abs().max()) > 0.9 * limit
    assert isinstance(m.gate, torch.nn.Linear) and m.gate.bias is not None
    out = m(torch.randn(2, 5, 64))
    assert out.shape == (2, 5, 64)
