"""paddle_tpu_torch's normalisation layers and functionals held to
paddle_tpu's.

Inputs are made with numpy from a seed and go through both packages,
float32 on the CPU, the port's parameters and buffers carried from the
JAX layer by `load_reference_state`:
- BatchNorm in training over k = 3 batches: each output within atol
  1e-5 x max(1, max |ref|), rtol 1e-5, and the running `_mean` /
  `_variance` after each step within rtol 1e-5, atol 1e-6 (paddle's
  momentum: running = 0.9 running + 0.1 batch, the variance unbiased);
  then eval mode over the buffers; gradients of a fixed random
  projection with respect to the input, weight and bias within 1e-4 x
  each one's largest |gradient|; `use_global_stats`, NHWC, BatchNorm1D
  on [N, C], the fluid `BatchNorm(act=)`;
- BatchNorm under `amp.auto_cast` (O1, bfloat16) on one bf16 input: it
  computes and emits float32 (the fp32 limits), and its running buffers,
  which the JAX package updates from the bf16 input's statistics rounded
  to bf16, agree to one bf16 step of a statistic (the same roundings,
  but a statistic at a rounding boundary may round apart, since the
  packages sum in other orders); after a bf16 conv,
  whose bf16 outputs the packages round apart here and there, outputs
  within test_torch_amp.py's bf16 limit, 2e-2 x max(1, max |ref|), and
  the buffers within 0.1 x it;
- GroupNorm, InstanceNorm (affine and not), LocalResponseNorm (the JAX
  package scales the window's sum by alpha), NCHW and channel last, and
  SpectralNorm with its vectors carried: outputs and gradients at the
  limits above;
- state-dict names: `weight`, `bias`, `_mean`, `_variance`;
  `SyncBatchNorm.convert_sync_batchnorm`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu import amp as jamp
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as tF

ATOL = 1e-5
RTOL = 1e-5
GRAD_SHARE = 1e-4


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            + shift).astype("float32")


def _close(got, want, what="", rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _bf16_close(got, want, what):
    """test_torch_amp.py's bfloat16 limit on an op's output: 2e-2 x
    max(1, max |ref|) (the packages accumulate the conv in other orders,
    so an element may sit one bf16 step apart)."""
    err = np.abs(got - want).max()
    assert err <= 2e-2 * max(1.0, float(np.abs(want).max())), (what, err)


def _state(layer):
    return {n: np.asarray(v.numpy()) for n, v in layer.state_dict().items()}


def _pair(name, *args, seed=1, **kw):
    """(JAX layer, port layer) with the JAX layer's random weight and bias
    (and buffers) carried into the port's."""
    ref = getattr(jnn, name)(*args, **kw)
    port = getattr(tnn, name)(*args, **kw)
    rng = np.random.RandomState(seed)
    for n, p in ref.named_parameters():
        p.set_value((rng.standard_normal(p.shape) * 0.5 + 1.0).astype(
            "float32"))
    load_reference_state(port, _state(ref))
    return ref, port


def _grads(ref, port, x, r, jfwd=None, tfwd=None):
    """Outputs of both on x, then every gradient (input and parameters)
    of sum(out * r) held to the JAX package's."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jo = (jfwd or ref)(jx)
    to = (tfwd or port)(tx)
    _close(to.detach().numpy(), jo.numpy(), "output")
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    pairs = [("x", jx.grad, tx.grad)] + [
        (n, p.grad, dict(port.named_parameters())[n].grad)
        for n, p in ref.named_parameters() if p.grad is not None]
    for n, g, t in pairs:
        g = np.asarray(g.numpy())
        err = np.abs(t.numpy() - g).max()
        assert err <= GRAD_SHARE * max(np.abs(g).max(), 1e-30), (n, err)


def _buffers_close(ref, port, what, rtol=RTOL):
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(
            getattr(port, n).numpy(), np.asarray(getattr(ref, n).numpy()),
            rtol=rtol, atol=1e-6, err_msg=f"{what} {n}")


@pytest.mark.parametrize("name,shape,kw", [
    ("BatchNorm2D", (4, 3, 5, 6), {}),
    ("BatchNorm2D", (4, 5, 6, 3), dict(data_format="NHWC")),
    ("BatchNorm1D", (16, 3), {}),
    ("BatchNorm1D", (4, 3, 7), dict(momentum=0.5, epsilon=1e-3)),
    ("BatchNorm3D", (2, 3, 3, 4, 5), {}),
], ids=["2d", "2d_nhwc", "1d_nc", "1d_ncl_momentum", "3d"])
def test_batch_norm_train_steps_and_eval_match_jax(name, shape, kw):
    """Three training steps (each batch its own shift and scale), the
    buffers after each; then eval mode, which reads them."""
    ref, port = _pair(name, 3, **kw)
    for step in range(3):
        x = _rand(10 + step, *shape, scale=1 + step, shift=step - 1)
        r = _rand(20 + step, *shape)
        _grads(ref, port, x, r)
        _buffers_close(ref, port, f"step {step}")
    ref.eval()
    port.eval()
    x = _rand(30, *shape, scale=2.0)
    _grads(ref, port, x, _rand(31, *shape))
    _buffers_close(ref, port, "after eval")


def test_momentum_is_paddles_and_variance_unbiased():
    """running = m running + (1 - m) batch with m = 0.9 (torch's momentum
    would be 0.1), the variance n / (n - 1) x the biased one."""
    bn = tnn.BatchNorm2D(2)
    x = torch.from_numpy(_rand(3, 4, 2, 3, 3, scale=2.0, shift=1.0))
    bn(x)
    n = 4 * 3 * 3
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), correction=0) * n / (n - 1)
    torch.testing.assert_close(bn._mean, 0.1 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn._variance, 0.9 + 0.1 * var, rtol=1e-5,
                               atol=1e-7)


def test_use_global_stats_reads_the_running_buffers():
    ref, port = _pair("BatchNorm2D", 3, use_global_stats=True)
    ref._mean.set_value(_rand(2, 3))
    ref._variance.set_value(np.abs(_rand(3, 3)) + 0.5)
    load_reference_state(port, _state(ref))
    x = _rand(4, 2, 3, 4, 4)
    _grads(ref, port, x, _rand(5, 2, 3, 4, 4))
    _buffers_close(ref, port, "use_global_stats")
    assert np.array_equal(port._mean.numpy(), _rand(2, 3))


def test_fluid_batch_norm_with_act_matches_jax():
    ref, port = _pair("BatchNorm", 3, act="relu")
    x = _rand(6, 2, 3, 4, 4)
    _grads(ref, port, x, _rand(7, 2, 3, 4, 4))
    _buffers_close(ref, port, "fluid")
    assert float(port(torch.from_numpy(x)).detach().min()) == 0.0


def test_batch_norm_under_o1_matches_jax():
    """BatchNorm under auto_cast(O1) on one bf16 input given to both
    packages: BN casts up, computes and emits float32 (the fp32 limits);
    the running buffers take the bf16 input's statistics rounded to bf16
    (and each (1 - momentum) x statistic product too), as the JAX
    package's side effect on the uncast input does. The packages sum the
    fp32 statistics in other orders, so a statistic at a bf16 rounding
    boundary may round one bf16 step (2^-7 relative at most) apart: each
    step's buffer is held to 0.9 x the last step's allowance + 0.1 x
    2^-7 x |its statistic| + 1e-6. From zero the buffer is exactly the
    port's bf16 product, not 0.1 x the fp32 mean."""
    jbn, tbn = jnn.BatchNorm2D(4), tnn.BatchNorm2D(4)
    lim = {"_mean": 0.0, "_variance": 0.0}
    for step in range(3):
        x = _rand(40 + step, 4, 4, 8, 8, scale=3.0, shift=step)
        jx = paddle.to_tensor(x).astype("bfloat16")
        tx = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(jx._value.astype("float32")),
                              tx.float().numpy())
        with jamp.auto_cast(level="O1", dtype="bfloat16"):
            jo = jbn(jx)
        with tamp.auto_cast(level="O1", dtype="bfloat16"):
            to = tbn(tx)
        assert to.dtype == torch.float32 and str(jo.dtype).endswith(
            "float32")
        _close(to.detach().numpy(), jo.numpy(), f"O1 step {step}")
        x32 = tx.float()
        stats = {"_mean": x32.mean((0, 2, 3)),
                 "_variance": x32.var((0, 2, 3), correction=1)}
        for n, stat in stats.items():
            lim[n] = 0.9 * lim[n] + 0.1 * 2.0 ** -7 * stat.abs().numpy()
            err = np.abs(getattr(tbn, n).numpy()
                         - np.asarray(getattr(jbn, n).numpy()))
            assert (err <= lim[n] + 1e-6).all(), (step, n, err, lim[n])
        if step == 0:
            m = stats["_mean"]
            bf = (m.to(torch.bfloat16) * (1 - 0.9)).float()
            torch.testing.assert_close(tbn._mean, bf, rtol=0, atol=0)
            assert not torch.allclose(tbn._mean, 0.1 * m, rtol=1e-5,
                                      atol=0)


def test_conv_batch_norm_chain_under_o1_matches_jax():
    """A bf16 conv feeding BatchNorm under O1: the conv emits bf16 and BN
    float32 in both packages, each output within test_torch_amp.py's bf16
    limit; the packages' bf16 convs round a few elements one bf16 step
    apart (their accumulation orders differ), so the buffers, 0.1 x those
    statistics, are held to 0.1 x that limit."""
    paddle.seed(2)
    jconv, jbn = jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4)
    tconv, tbn = tnn.Conv2D(3, 4, 3, padding=1), tnn.BatchNorm2D(4)
    load_reference_state(tconv, _state(jconv))
    for step in range(2):
        x = _rand(50 + step, 4, 3, 8, 8, scale=3.0, shift=step)
        with jamp.auto_cast(level="O1", dtype="bfloat16"):
            jy = jconv(paddle.to_tensor(x))
            jo = jbn(jy)
        with tamp.auto_cast(level="O1", dtype="bfloat16"):
            ty = tconv(torch.from_numpy(x))
            to = tbn(ty)
        assert ty.dtype == torch.bfloat16 and str(jy.dtype).endswith(
            "bfloat16")
        assert to.dtype == torch.float32 and str(jo.dtype).endswith(
            "float32")
        want_y = np.asarray(jy._value.astype("float32"))
        _bf16_close(ty.float().detach().numpy(), want_y, "conv")
        _bf16_close(to.detach().numpy(), jo.numpy(), "bn")
        lim = 0.1 * 2e-2 * max(1.0, float(np.abs(want_y).max()))
        for n in ("_mean", "_variance"):
            err = np.abs(getattr(tbn, n).numpy()
                         - np.asarray(getattr(jbn, n).numpy())).max()
            assert err <= lim, (step, n, err, lim)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_group_norm_matches_jax(data_format):
    ref, port = _pair("GroupNorm", 2, 6, data_format=data_format)
    shape = (2, 6, 4, 5) if data_format == "NCHW" else (2, 4, 5, 6)
    _grads(ref, port, _rand(8, *shape, scale=2.0), _rand(9, *shape))


@pytest.mark.parametrize("name,shape,kw", [
    ("InstanceNorm2D", (2, 3, 4, 5), {}),
    ("InstanceNorm1D", (2, 3, 7), dict(weight_attr=False)),
    ("InstanceNorm3D", (2, 4, 3, 3, 3), dict(data_format="NDHWC")),
], ids=["2d", "1d_no_affine", "3d_ndhwc"])
def test_instance_norm_matches_jax(name, shape, kw):
    ref, port = _pair(name, shape[-1] if kw.get("data_format") else
                      shape[1], **kw)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    _grads(ref, port, _rand(10, *shape, scale=3.0), _rand(11, *shape))


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_local_response_norm_matches_jax(data_format):
    ref, port = _pair("LocalResponseNorm", 3, alpha=1e-2, beta=0.75, k=1.5,
                      data_format=data_format)
    shape = (2, 6, 4, 4) if data_format == "NCHW" else (2, 4, 4, 6)
    _grads(ref, port, _rand(12, *shape, scale=3.0), _rand(13, *shape))


def test_spectral_norm_matches_jax():
    """Power iteration from the carried weight_u / weight_v; the gradient
    reaches the weight through the iterations."""
    paddle.seed(4)
    ref = jnn.SpectralNorm([6, 4, 3], dim=1, power_iters=2)
    port = tnn.SpectralNorm([6, 4, 3], dim=1, power_iters=2)
    assert sorted(port.state_dict()) == ["weight_u", "weight_v"]
    assert not port.weight_u.requires_grad
    load_reference_state(port, _state(ref))
    w = _rand(14, 6, 4, 3)
    _grads(ref, port, w, _rand(15, 6, 4, 3))


def test_batch_norm_state_names_and_sync_conversion():
    want = ["weight", "bias", "_mean", "_variance"]
    for name in ("BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
                 "SyncBatchNorm"):
        assert list(getattr(tnn, name)(4).state_dict()) == want
        assert list(getattr(jnn, name)(4).state_dict()) == want
    assert list(tnn.BatchNorm(4).state_dict()) == want
    assert list(tnn.BatchNorm2D(4, weight_attr=False, bias_attr=False)
                .state_dict()) == ["_mean", "_variance"]
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4),
                         tnn.Sequential(tnn.BatchNorm2D(4)))
    for bn in (net[1], net[2][0]):
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn._mean.uniform_(-1, 1)
    x = torch.from_numpy(_rand(16, 2, 3, 6, 6))
    net.eval()
    want_out = net(x)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert out is net
    assert type(net[1]) is tnn.SyncBatchNorm
    assert type(net[2][0]) is tnn.SyncBatchNorm
    assert type(net[0]) is tnn.Conv2D
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    net.eval()
    assert torch.equal(net(x), want_out)
    single = tnn.SyncBatchNorm.convert_sync_batchnorm(tnn.BatchNorm2D(4))
    assert type(single) is tnn.SyncBatchNorm


def test_functional_batch_norm_matches_jax_without_layers():
    """F.batch_norm called directly, training, with weight and bias None
    and NHWC; the caller's buffers updated in place."""
    x = _rand(17, 3, 4, 5, 2, scale=2.0)
    rm, rv = _rand(18, 2), np.abs(_rand(19, 2)) + 0.5
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    jo = jF.batch_norm(paddle.to_tensor(x), jrm, jrv, training=True,
                       momentum=0.8, data_format="NHWC")
    to = tF.batch_norm(torch.from_numpy(x), trm, trv, training=True,
                       momentum=0.8, data_format="NHWC")
    _close(to.numpy(), jo.numpy())
    _close(trm.numpy(), jrm.numpy())
    _close(trv.numpy(), jrv.numpy())
