"""O2's `amp.decorate` casts parameters only, held to paddle_tpu.amp.

The JAX package's `decorate` calls `Layer.to(dtype=)`, which casts
`parameters()` and leaves every buffer as it is: BatchNorm's running
`_mean` and `_variance` stay float32. The port once called torch's
`Module.to(dtype)`, which also cast those buffers to bfloat16 (ROADMAP
C15). On the same numpy-seeded weights (carried by
`load_reference_state`):

- after `decorate(level="O2")` every parameter is bfloat16 and every
  buffer keeps the JAX package's dtype (float32), the parameters stay the
  same objects;
- one `train_batch` under `amp_configs="O2"` (SGD) updates the running
  buffers in float32 in both packages, within 1e-3 x max(1, max |ref|):
  both read the batch statistics of the same bf16 activations and
  compute them in float32 (the BatchNorm op is on AMP's black list), so
  they differ by the bf16 conv's summation order only (the bf16 limit of
  test_torch_norm.py is 2e-2, and its buffer limit a tenth of it).
"""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import hapi, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_reference_state

BUFFER_TOL = 1e-3


def _net(nn, base):
    """Conv2D -> BatchNorm2D -> ReLU -> Linear, in either package."""
    class Net(base):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.bn = nn.BatchNorm2D(4)
            self.act = nn.ReLU()
            self.fc = nn.Linear(4 * 6 * 6, 3)

        def forward(self, x):
            h = self.act(self.bn(self.conv(x)))
            return self.fc(h.reshape([h.shape[0], -1]))
    return Net()


def _pair(seed=0):
    paddle.seed(seed)
    jnet = _net(jnn, jnn.Layer)
    tnet = _net(tnn, torch.nn.Module)
    load_reference_state(tnet, {k: np.asarray(v.numpy()) for k, v in
                                jnet.state_dict().items()})
    return jnet, tnet


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "").replace("paddle.", "")


def test_o2_decorate_keeps_buffers_float32_as_jax():
    jnet, tnet = _pair()
    params = [id(p) for p in tnet.parameters()]
    jnet = jamp.decorate(jnet, level="O2")
    assert tamp.decorate(tnet, level="O2") is tnet
    assert [id(p) for p in tnet.parameters()] == params
    want = {k: np.asarray(v._value).dtype.name
            for k, v in jnet.state_dict().items()}
    got = {k: _dtype_name(v) for k, v in tnet.state_dict().items()}
    assert want["bn._mean"] == want["bn._variance"] == "float32"
    assert want["conv.weight"] == "bfloat16"
    assert got == want


def test_o2_train_step_buffers_match_jax():
    jnet, tnet = _pair(1)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((8, 3, 6, 6)).astype("float32")
    y = rng.randint(0, 3, (8,)).astype(np.int64)
    jnet = jamp.decorate(jnet, level="O2")
    tamp.decorate(tnet, level="O2")
    jm = paddle.Model(jnet)
    jm.prepare(paddle.optimizer.SGD(0.1, parameters=jnet.parameters()),
               paddle.nn.CrossEntropyLoss(), amp_configs="O2")
    # the single-device JAX step, whatever fleet state another test file
    # in this process left (as tests/test_torch_packed_fit.py does)
    jm._dist_ctx = None
    tm = hapi.Model(tnet).prepare(optimizer.SGD(0.1),
                                  tnn.CrossEntropyLoss(),
                                  amp_configs={"level": "O2"})
    jl = float(np.asarray(jm.train_batch([x], [y])[0][0]))
    tl = float(tm.train_batch([x], [y])[0][0])
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    jm._sync_carry()
    jstate = jnet.state_dict()
    for name in ("bn._mean", "bn._variance"):
        want = np.asarray(jstate[name]._value)
        got = dict(tnet.named_buffers())[name]
        assert want.dtype == np.float32 and got.dtype == torch.float32
        err = np.abs(got.numpy() - want).max()
        assert err <= BUFFER_TOL * max(1.0, float(np.abs(want).max())), \
            (name, err)
        # the step moved them off their initial zeros / ones
        assert np.abs(want - (0.0 if name.endswith("_mean") else 1.0)
                      ).max() > 1e-3
