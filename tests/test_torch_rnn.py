"""nn's recurrent layers: paddle_tpu_torch held to paddle_tpu on the same
weights (`models.load_reference_state`, nothing transposed: the
parameter names and layouts are the same in both, and torch's) and the
same numpy inputs, over 8 time steps. The JAX side of every case runs
under one shared `jax.jit`.

- The fused layers in every mode (SimpleRNN tanh and relu, GRU, LSTM,
  bidirectional, 2 layers, time-major): outputs, last states and the
  gradients of the input and of every parameter within
  1e-4 x max(1, max |ref|).
- The cells (one step) within 1e-5; `RNN` and `BiRNN` over them.
- Reproduced from the reference (ROADMAP C23): the fused layers ignore
  `initial_states`, `sequence_length` and `dropout`, in both packages.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import load_reference_state
from torch_ops_parity import (compare, host,  # noqa: F401
                              jax_jit_grads_many, on_the_cpu, r)

B, T, IN, H = 3, 8, 5, 6
RNN_TOL = 1e-4
H0, C0 = r(5, B, H), r(6, B, H)
IGNORED = {"states": np.ones((2, B, H), np.float32),
           "lengths": np.array([2, 3, 4], np.int64)}

FUSED = {
    "simple_rnn_tanh": ("SimpleRNN", {}),
    "simple_rnn_relu": ("SimpleRNN", {"activation": "relu"}),
    "gru": ("GRU", {}),
    "lstm": ("LSTM", {}),
    "lstm_bidirect_2layers": ("LSTM", {"num_layers": 2,
                                       "direction": "bidirect"}),
    "gru_2layers_time_major": ("GRU", {"num_layers": 2,
                                       "time_major": True}),
}
CELLS = {"SimpleRNNCell": {}, "SimpleRNNCell#relu": {"activation": "relu"},
         "LSTMCell": {}, "GRUCell": {}}


def _pair(jlayer, tlayer):
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    load_reference_state(tlayer, state)
    return jlayer, tlayer


def _cell_states(P, cls):
    t = torch.from_numpy if P is ptt else paddle.to_tensor
    return (t(H0), t(C0)) if cls == "LSTMCell" else t(H0)


def _cases():
    """{key: (JAX layer, port layer, call(P, layer, x), x, seed)}: the
    layers built from one seed each, the port's carrying the JAX
    weights."""
    out = {}
    for case, (cls, kw) in FUSED.items():
        paddle.seed(1)
        x = r(2, *((T, B, IN) if kw.get("time_major") else (B, T, IN)))
        out[case] = _pair(getattr(paddle.nn, cls)(IN, H, **kw),
                          getattr(ptt.nn, cls)(IN, H, **kw)) + (
            lambda P, layer, xx: layer(xx), x, 7)
    for name, kw in CELLS.items():
        cls = name.split("#")[0]
        paddle.seed(3)
        jc, tc = _pair(getattr(paddle.nn, cls)(IN, H, **kw),
                       getattr(ptt.nn, cls)(IN, H, **kw))
        out[name] = (jc, tc, lambda P, layer, xx, cls=cls: layer(
            xx, _cell_states(P, cls)), r(4, B, IN), 7)
        # no states: zeros, as get_initial_states gives them
        paddle.seed(3)
        out[name + " zeros"] = _pair(
            getattr(paddle.nn, cls)(IN, H, **kw),
            getattr(ptt.nn, cls)(IN, H, **kw)) + (
            lambda P, layer, xx: layer(xx), r(4, B, IN), 7)
    for reverse in (False, True):
        paddle.seed(4)
        jc, tc = _pair(paddle.nn.GRUCell(IN, H), ptt.nn.GRUCell(IN, H))
        out[f"RNN reverse={reverse}"] = (
            paddle.nn.RNN(jc, is_reverse=reverse),
            ptt.nn.RNN(tc, is_reverse=reverse),
            lambda P, layer, xx: layer(xx), r(7, B, T, IN), 7)
    paddle.seed(5)
    jf, tf = _pair(paddle.nn.LSTMCell(IN, H), ptt.nn.LSTMCell(IN, H))
    jb, tb = _pair(paddle.nn.LSTMCell(IN, H), ptt.nn.LSTMCell(IN, H))
    out["BiRNN"] = (paddle.nn.BiRNN(jf, jb), ptt.nn.BiRNN(tf, tb),
                    lambda P, layer, xx: layer(xx), r(8, B, T, IN), 7)

    def ignoring(P, layer, xx):
        """The plain call, then one with states, lengths and (the
        layer's) dropout in training mode: the same values."""
        t = torch.from_numpy if P is ptt else paddle.to_tensor
        h0 = t(IGNORED["states"])
        return layer(xx), layer(xx, (h0, h0), sequence_length=t(
            IGNORED["lengths"]))
    paddle.seed(2)
    out["lstm ignores"] = _pair(
        paddle.nn.LSTM(IN, H, num_layers=2, dropout=0.5),
        ptt.nn.LSTM(IN, H, num_layers=2, dropout=0.5)) + (
        ignoring, r(3, B, T, IN), 7)
    return out


@functools.lru_cache(maxsize=None)
def _built():
    cases = _cases()
    want = jax_jit_grads_many({
        k: (lambda xx, jl=jl, call=call: call(paddle, jl, xx), [x], [0], jl,
            seed)
        for k, (jl, _, call, x, seed) in cases.items()})
    return cases, want


def _check(key, tol):
    """Outputs and last states of the port's layer on the case's input,
    and the gradients of sum(out * w) for the input and every parameter,
    against the JAX layer's."""
    cases, wants = _built()
    _, tlayer, call, x, seed = cases[key]
    want, (jdx,), jgrads = wants[key]
    tlayer.train()
    tlayer.zero_grad(set_to_none=True)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    got = call(ptt, tlayer, tx)
    compare(key, got, want, tol)
    out = got[0]
    out = out[0] if isinstance(out, tuple) else out
    w = np.random.RandomState(seed).standard_normal(
        tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    compare(f"{key} dx", tx.grad, jdx, tol)
    assert sorted(n for n, _ in tlayer.named_parameters()) == sorted(jgrads)
    for pname, p in tlayer.named_parameters():
        compare(f"{key} d{pname}", p.grad, jgrads[pname], tol)
    return got, want


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_rnn_matches_jax(case):
    _check(case, RNN_TOL)


def test_fused_lstm_ignores_initial_states_length_and_dropout():
    """In training mode, with dropout 0.5, h0 = c0 = 1 and lengths
    [2, 3, 4], both packages give what the plain call gives: zero
    initial states, every frame, no dropout."""
    got, want = _check("lstm ignores", RNN_TOL)
    for pair in (got, want):
        (out, (h, c)), (out2, (h2, c2)) = pair
        for a, b in ((out, out2), (h, h2), (c, c2)):
            np.testing.assert_array_equal(host(b), host(a))
    # torch's own LSTM on the same weights from zero states, no dropout
    tl = _built()[0]["lstm ignores"][1]
    lib = torch.nn.LSTM(IN, H, num_layers=2, batch_first=True)
    lib.load_state_dict(tl.state_dict())
    x = torch.from_numpy(_built()[0]["lstm ignores"][3])
    lout, (lh, _) = lib(x)
    torch.testing.assert_close(got[0][0].detach(), lout.detach())
    torch.testing.assert_close(got[0][1][0].detach(), lh.detach())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_matches_jax(name):
    _check(name, 1e-5)
    _check(name + " zeros", 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_over_a_cell_matches_jax(reverse):
    """`RNN` steps the cell; `sequence_length` is taken and unused."""
    key = f"RNN reverse={reverse}"
    _check(key, RNN_TOL)
    tr = _built()[0][key][1]
    x = torch.from_numpy(_built()[0][key][3])
    torch.testing.assert_close(
        tr(x, sequence_length=torch.tensor([1, 2, 3]))[0], tr(x)[0],
        rtol=0, atol=0)


def test_birnn_matches_jax():
    _check("BiRNN", RNN_TOL)
