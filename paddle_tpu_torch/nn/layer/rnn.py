"""Recurrent layers (port of `paddle_tpu.nn.layer.rnn`, `rnn.py:22-332`
there; reference `python/paddle/nn/layer/rnn.py`, `operators/rnn_op`).

Parameter names and layouts are the reference's, which are also
torch's: `weight_ih` [gates * H, in], `weight_hh` [gates * H, H],
`bias_ih`, `bias_hh` on a cell, and `weight_ih_l{k}[_reverse]` and so on
on the fused layers, so `models.load_reference_state` copies them as
they are. Gate order: LSTM [i, f, g, o]; GRU [r, z, c] with the
candidate tanh(W_ic x + b_ic + r * (W_hc h + b_hc)) — cuDNN's too.

- The cells run the reference's expression in plain torch ops.
- `RNN` and `BiRNN` step a cell in a Python loop, as the reference does.
- `SimpleRNN`, `LSTM` and `GRU` run torch's fused recurrence
  (`torch._VF.rnn_tanh` / `rnn_relu` / `lstm` / `gru`: cuDNN on the
  card, torch's own kernels on the CPU). The JAX package runs a
  `lax.scan` here, no TPU kernel.

Reproduced from the reference (ROADMAP C23): the fused layers ignore
`initial_states` (zeros), `sequence_length` and `dropout`
(`rnn.py:267-313` there), and `RNN` / `BiRNN` ignore `sequence_length`
(`:167-199`)."""
from __future__ import annotations

import math

import torch

from ...ops._util import named
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        """[batch, hidden_size] of `init_value` on batch_ref's device
        (`shape` is taken and unused, as in the reference)."""
        batch = batch_ref.shape[batch_dim_idx]
        return torch.full([batch, self.hidden_size], init_value,
                          dtype=getattr(torch, str(dtype)),
                          device=batch_ref.device)

    def _make_weights(self, gates, input_size, hidden_size, attrs):
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        wi, wh, bi, bh = attrs
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], wi, default_initializer=u)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], wh, default_initializer=u)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], bi, is_bias=True, default_initializer=u)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], bh, is_bias=True, default_initializer=u)

    def _gates(self, name, x, h):
        """(x W_ih^T + b_ih, h W_hh^T + b_hh) through AMP by `name`."""
        x, h, wi, wh, bi, bh = named(name, x, h, self.weight_ih,
                                     self.weight_hh, self.bias_ih,
                                     self.bias_hh)
        return x @ wi.T + bi, h @ wh.T + bh


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._make_weights(1, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi, gh = self._gates("simple_rnn_cell", inputs, states)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h = act(gi + gh)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make_weights(4, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    def forward(self, inputs, states=None):
        """(h, (h, c)): the new hidden state, and the new states."""
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        gi, gh = self._gates("lstm_cell", inputs, h)
        i, f, g, o = torch.chunk(gi + gh, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make_weights(3, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi, gh = self._gates("gru_cell", inputs, states)
        ir, iz, ic = torch.chunk(gi, 3, dim=-1)
        hr, hz, hc = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h = (1 - z) * c + z * states
        return h, h


class RNN(Layer):
    """Steps `cell(x_t, states) -> (out, states)` over the time axis
    (reversed with `is_reverse`); returns (outputs stacked on the time
    axis, the last states). `sequence_length` is taken and unused."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        states = initial_states
        outs = []
        for t in order:
            xt = inputs[:, t] if time_axis == 1 else inputs[t]
            out, states = self.cell(xt, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=time_axis), states


class BiRNN(Layer):
    """A forward and a reversed `RNN`, outputs concatenated on the last
    axis; states (forward's, backward's)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        o_fw, s_fw = self.rnn_fw(inputs, s_fw)
        o_bw, s_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([o_fw, o_bw], dim=-1), (s_fw, s_bw)


_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}
_FUSED = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": "rnn_tanh",
          "RNN_RELU": "rnn_relu"}


class _RNNBase(Layer):
    _mode = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirectional else 1
        self.num_directions = num_dir
        g = _GATES[self._mode]
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self._param_names = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * num_dir
            for d in range(num_dir):
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                for n, shape, attr, bias in (
                        (f"weight_ih{sfx}", [g * hidden_size, in_sz],
                         weight_ih_attr, False),
                        (f"weight_hh{sfx}", [g * hidden_size, hidden_size],
                         weight_hh_attr, False),
                        (f"bias_ih{sfx}", [g * hidden_size], bias_ih_attr,
                         True),
                        (f"bias_hh{sfx}", [g * hidden_size], bias_hh_attr,
                         True)):
                    self.add_parameter(n, self.create_parameter(
                        shape, attr, is_bias=bias, default_initializer=u))
                    self._param_names.append(n)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """(outputs, last states): LSTM's states are (h, c), the others'
        h, each [num_layers * num_directions, B, H]. Starts from zero
        states with no dropout, whatever `initial_states`,
        `sequence_length` and `dropout` say (C23)."""
        name = _FUSED[self._mode]
        x, *weights = named(name, inputs,
                            *[getattr(self, n) for n in self._param_names])
        B = x.shape[1 if self.time_major else 0]
        zeros = torch.zeros(self.num_layers * self.num_directions, B,
                            self.hidden_size, dtype=x.dtype, device=x.device)
        fused = getattr(torch._VF, name)
        if self._mode == "LSTM":
            out, h, c = fused(x, (zeros, zeros), weights, True,
                              self.num_layers, 0.0, self.training,
                              self.bidirectional, not self.time_major)
            return out, (h, c)
        out, h = fused(x, zeros, weights, True, self.num_layers, 0.0,
                       self.training, self.bidirectional,
                       not self.time_major)
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        self._mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    _mode = "LSTM"


class GRU(_RNNBase):
    _mode = "GRU"
