"""The port's nn layers and functionals held to paddle_tpu's in float32,
on the same numpy inputs, to 1e-6 x max(1, max |ref|) (float32 rounding
of the same expressions, summed in another order).

Linear's bridge (PyTorch's [out, in] weight against the JAX package's
[in, out]), LayerNorm's epsilon, exact and tanh GELU, matmul's transpose
flags, softmax's axis and dtype, embedding's padding rows (zero output,
zero gradient), and dropout on statistics (its bits come from another
generator): the kept share, the scaling, `axis` and both modes."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import linalg as JL
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import linalg as TL

TOL = 1e-6


def _close(got, ref):
    want = np.asarray(ref.numpy())
    got = got.detach().numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _rand(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_layer_bridges_the_weight_layout(bias):
    paddle.seed(1)
    ref = paddle.nn.Linear(8, 5, bias_attr=None if bias else False)
    port = nn.Linear(8, 5, bias=bias)
    assert isinstance(port, torch.nn.Linear)
    assert tuple(port.weight.shape) == (5, 8)
    load_reference_state(port, {k: np.asarray(v.numpy()) for k, v in
                                ref.state_dict().items()})
    x = _rand(2, 3, 4, 8)
    _close(port(torch.from_numpy(x)), ref(paddle.to_tensor(x)))
    w, b = _rand(3, 8, 5), _rand(4, 5)
    _close(TF.linear(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b) if bias else None),
           JF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b) if bias else None))


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("shape", [[16], [4, 16]])
def test_layer_norm_epsilon_and_shape(eps, shape):
    x = 3 * _rand(5, 2, 4, 16) + 1
    w, b = 1 + _rand(6, *shape), _rand(7, *shape)
    ref = JF.layer_norm(paddle.to_tensor(x), shape, paddle.to_tensor(w),
                        paddle.to_tensor(b), eps)
    _close(TF.layer_norm(torch.from_numpy(x), shape, torch.from_numpy(w),
                         torch.from_numpy(b), eps), ref)
    layer = nn.LayerNorm(shape, eps=eps)
    jl = paddle.nn.LayerNorm(shape, epsilon=eps)
    assert isinstance(layer, torch.nn.LayerNorm)
    _close(layer(torch.from_numpy(x)), jl(paddle.to_tensor(x)))
    _close(TF.layer_norm(torch.from_numpy(x), shape, epsilon=eps),
           JF.layer_norm(paddle.to_tensor(x), shape, epsilon=eps))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_exact_and_tanh(approximate):
    x = 3 * _rand(8, 4, 32)
    ref = JF.gelu(paddle.to_tensor(x), approximate=approximate)
    _close(TF.gelu(torch.from_numpy(x), approximate=approximate), ref)
    _close(nn.GELU(approximate)(torch.from_numpy(x)),
           paddle.nn.GELU(approximate)(paddle.to_tensor(x)))
    if not approximate:
        # exact: differs from the tanh form by more than the tolerance
        tanh = TF.gelu(torch.from_numpy(x), approximate=True).numpy()
        assert np.abs(tanh - np.asarray(ref.numpy())).max() > 1e-5


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_transpose_flags(tx, ty):
    a = _rand(9, *((3, 7, 4) if tx else (3, 4, 7)))
    b = _rand(10, *((3, 5, 7) if ty else (3, 7, 5)))
    _close(TL.matmul(torch.from_numpy(a), torch.from_numpy(b), tx, ty),
           JL.matmul(paddle.to_tensor(a), paddle.to_tensor(b), tx, ty))


def test_mm_bmm_einsum_and_one_d():
    a, b = _rand(11, 4, 7), _rand(12, 7, 5)
    _close(TL.mm(torch.from_numpy(a), torch.from_numpy(b)),
           JL.mm(paddle.to_tensor(a), paddle.to_tensor(b)))
    a3, b3 = _rand(13, 2, 4, 7), _rand(14, 2, 7, 5)
    _close(TL.bmm(torch.from_numpy(a3), torch.from_numpy(b3)),
           JL.bmm(paddle.to_tensor(a3), paddle.to_tensor(b3)))
    _close(TL.einsum("bij,bjk->bki", torch.from_numpy(a3),
                     torch.from_numpy(b3)),
           JL.einsum("bij,bjk->bki", paddle.to_tensor(a3),
                     paddle.to_tensor(b3)))
    v = _rand(15, 4)
    # a 1-D operand is never transposed
    _close(TL.matmul(torch.from_numpy(a), torch.from_numpy(v), True, True),
           JL.matmul(paddle.to_tensor(a), paddle.to_tensor(v), True, True))


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_and_log_softmax(axis):
    x = 4 * _rand(16, 3, 5, 6)
    for name in ("softmax", "log_softmax"):
        _close(getattr(TF, name)(torch.from_numpy(x), axis),
               getattr(JF, name)(paddle.to_tensor(x), axis))
    x16 = torch.from_numpy(x).half()
    assert TF.softmax(x16, dtype="float32").dtype == torch.float32


def test_embedding_padding_rows():
    ids = np.array([[1, 3, 0, 3], [2, 2, 3, 4]])
    w = _rand(17, 6, 8)
    wt = torch.from_numpy(w).requires_grad_()
    out = TF.embedding(torch.from_numpy(ids), wt, padding_idx=3)
    _close(out, JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                             padding_idx=3))
    out.sum().backward()
    assert (wt.grad[3] == 0).all() and (wt.grad[2] == 2).all()
    layer = nn.Embedding(6, 8, padding_idx=-1)
    assert isinstance(layer, torch.nn.Embedding)
    assert layer.padding_idx == 5 and (layer.weight[5] == 0).all()
    assert (layer(torch.tensor([[5, 1]]))[0, 0] == 0).all()


def test_dropout_statistics():
    torch.manual_seed(0)
    x = torch.ones(64, 4096)
    p = 0.3
    out = TF.dropout(x, p)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 5e-3
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / (1 - p)))
    assert TF.dropout(x, p, training=False) is x
    assert TF.dropout(x, 0.0) is x
    # axis: one draw per row, shared along the columns
    rows = TF.dropout(x, p, axis=0)
    assert ((rows == 0).all(1) | (rows != 0).all(1)).all()
    assert abs((rows[:, 0] != 0).float().mean().item() - (1 - p)) < 0.15
    down = TF.dropout(x, p, mode="downscale_in_infer")
    assert set(down.unique().tolist()) == {0.0, 1.0}
    layer = nn.Dropout(p)
    assert isinstance(layer, torch.nn.Dropout)
    layer.eval()
    assert layer(x) is x
    layer.train()
    assert (layer(x) == 0).any()


def test_gpt_layers_keep_names_and_layout():
    """The GPT built from the port's layers keeps the JAX package's
    parameter names and PyTorch's Linear layout."""
    cfg = GPTConfig.tiny()
    net = GPTForCausalLM(cfg, device="cpu")
    ref = paddle.models.GPTForCausalLM(paddle.models.GPTConfig.tiny())
    assert set(net.state_dict()) == set(ref.state_dict())
    assert isinstance(net.gpt.blocks[0].mlp[0], nn.Linear)
    assert isinstance(net.gpt.blocks[0].mlp[1], nn.GELU)
    assert isinstance(net.gpt.ln_f, nn.LayerNorm)
    assert isinstance(net.gpt.wte, nn.Embedding)
    assert tuple(net.gpt.blocks[0].mlp[0].weight.shape) == (
        cfg.intermediate_size, cfg.hidden_size)
