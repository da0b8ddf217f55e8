"""The port's weight-only quantization held to paddle_tpu's.

Every case makes its weights with numpy from a seed and runs them
through both packages. The JAX package stores Linear weights [in, out],
the port [out, in], so a JAX tensor is compared with the transpose of
the port's.

- `weight_quantize` / `weight_dequantize`: int8 codes equal, scales
  within 1 ulp (the divisions are tensor divisions in the port, numpy's
  in the JAX package), int8 and int4, odd output counts included;
  dequantized weights equal.
- `pack_int4` / `unpack_int4`: the round trip, and packed bytes equal to
  the JAX package's (the same output channels share a byte).
- `weight_only_linear`: within rtol 1e-5, atol 1e-5 of the JAX output
  (float32 matmul order); under `amp.auto_cast` it runs in bfloat16 as
  the JAX op does, its storage untouched.
- `quantize_weights`: nested Linears swapped, tied Linears stay one
  module, fake-quant wrappers keep their inner Linear.
- `QuantizedConv2D` and the Conv2D branch of
  `ImperativeQuantAware.quantize`: a small conv net's outputs and input
  gradient (the straight-through estimator) within rtol 1e-5, atol 1e-5
  x max(1, max |ref|) of the JAX package's, strided, padded and grouped
  convolutions, NHWC; `save_quantized_model` writes a `jit.save`
  artifact (tests/test_torch_quant_pass.py runs it).
- `load_reference_state` carries a quantized JAX GPT's integers and
  scales across as they are; `decode_weights` hands int8 leaves (int4
  unpacked once).
- The port's quantized `generate()` is token-identical to the JAX
  package's quantized `generate()` at `GPTConfig.tiny()`, bits 8 and 4,
  and the port's engine on the quantized model to its own generate().
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import amp as jamp
from paddle_tpu import quantization as jquant
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.serving import GenerationEngine

SHAPES = [(16, 7), (16, 8), (5, 9), (3, 1), (64, 33)]   # [in, out]
ALGOS = ["weight_only_int8", "weight_only_int4"]


def _ulps(a, b):
    """Largest distance in float32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("shape", SHAPES)
def test_weight_quantize_codes_and_scales_match_jax(shape, algo):
    w = np.random.RandomState(sum(shape)).standard_normal(shape) \
        .astype("float32")
    qj, sj = jq.weight_quantize(w, algo)
    qt, st = tq.weight_quantize(torch.from_numpy(w.T.copy()), algo)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), qj.T)
    assert _ulps(st.numpy(), sj) <= 1
    np.testing.assert_array_equal(
        tq.weight_dequantize(qt, st, algo).numpy(),
        np.asarray(jq.weight_dequantize(qj, sj, algo)).T)


@pytest.mark.parametrize("shape", SHAPES)
def test_int4_pack_round_trip_and_bytes(shape):
    rng = np.random.RandomState(7)
    q = rng.randint(-7, 8, size=shape).astype(np.int8)     # [in, out]
    packed_j = jq.pack_int4(q)
    packed_t = tq.pack_int4(torch.from_numpy(q.T.copy()))
    assert tuple(packed_t.shape) == ((shape[1] + 1) // 2, shape[0])
    np.testing.assert_array_equal(packed_t.numpy(), packed_j.T)
    np.testing.assert_array_equal(
        tq.unpack_int4(packed_t, shape[1]).numpy(), q.T)
    np.testing.assert_array_equal(
        tq.unpack_int4(packed_t, shape[1]).numpy(),
        np.asarray(jq.unpack_int4(packed_j, shape[1])).T)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_weight_only_linear_matches_jax(dtype):
    rng = np.random.RandomState(3)
    w = rng.standard_normal((32, 17)).astype("float32")
    b = rng.standard_normal((17,)).astype("float32")
    x = rng.standard_normal((4, 32)).astype("float32")
    algo = f"weight_only_{dtype}"
    qj, sj = jq.weight_quantize(w, algo)
    qt, st = tq.weight_quantize(torch.from_numpy(w.T.copy()), algo)
    want = jq.weight_only_linear(paddle.to_tensor(x), paddle.to_tensor(qj),
                                 paddle.to_tensor(sj), paddle.to_tensor(b),
                                 weight_dtype=dtype).numpy()
    got = tq.weight_only_linear(torch.from_numpy(x), qt, st,
                                torch.from_numpy(b), weight_dtype=dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _pair_linear(seed, i, o):
    """A JAX Linear and a port Linear with the same numpy weights."""
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((i, o)).astype("float32") * 0.3
    b = rng.standard_normal((o,)).astype("float32")
    jl = jnn.Linear(i, o)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    tl = tnn.Linear(i, o)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T.copy()))
        tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_only_linear_module_matches_jax(bits):
    jl, tl = _pair_linear(5, 32, 17)
    jw = jquant.WeightOnlyLinear(jl, bits=bits)
    tw = tquant.WeightOnlyLinear(tl, bits=bits)
    x = np.random.RandomState(6).standard_normal((4, 32)).astype("float32")
    np.testing.assert_allclose(tw(torch.from_numpy(x)).detach().numpy(),
                               jw(paddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    name = f"weight_int{bits}"
    np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                  getattr(jw, name).numpy().T)
    assert getattr(tw, name).dtype == torch.int8
    assert not any(p.dtype == torch.float32 and p.dim() == 2
                   for p in tw.parameters())          # no float weight kept
    assert tw.quant_weight_spec() == jw.quant_weight_spec()


def test_quantize_weights_nested_and_tied():
    torch.manual_seed(1)
    net = torch.nn.Sequential(tnn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Sequential(tnn.Linear(16, 8),
                                                  torch.nn.Tanh()),
                              tnn.Linear(8, 2))
    x = torch.randn(4, 8)
    ref = net(x).detach()
    tquant.quantize_weights(net)
    kinds = [type(m).__name__ for m in net.modules()]
    assert kinds.count("WeightOnlyLinear") == 3 and "Linear" not in kinds
    np.testing.assert_allclose(net(x).detach().numpy(), ref.numpy(),
                               rtol=0.08, atol=0.08)

    shared = tnn.Linear(8, 8)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = shared
            self.b = shared

        def forward(self, x):
            return self.a(x) + self.b(x)

    tied = tquant.quantize_weights(Net())
    assert tied.a is tied.b
    assert isinstance(tied.a, tquant.WeightOnlyLinear)


def test_fake_quant_wrappers_left_intact_and_match_jax():
    jl, tl = _pair_linear(9, 8, 8)
    jnet = jnn.Sequential(jl, jnn.ReLU())
    tnet = torch.nn.Sequential(tl, torch.nn.ReLU())
    jquant.PTQ().quantize(jnet)
    tquant.PTQ().quantize(tnet)
    assert isinstance(tnet[0], tquant.QuantizedLinear)
    jquant.quantize_weights(jnet)
    tquant.quantize_weights(tnet)
    assert isinstance(tnet[0], tquant.QuantizedLinear)
    assert isinstance(tnet[0].inner, torch.nn.Linear)
    x = np.random.RandomState(2).standard_normal((2, 8)).astype("float32")
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               jnet(paddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    v = np.random.RandomState(4).standard_normal((5, 7)).astype("float32")
    np.testing.assert_allclose(
        tquant.fake_quantize_dequantize(torch.from_numpy(v), 4).numpy(),
        jquant.fake_quantize_dequantize(paddle.to_tensor(v), 4).numpy(),
        rtol=1e-6, atol=1e-6)


def test_unported_parts_raise(tmp_path):
    """`save_quantized_model` is ported now (through `jit.save`, as the
    JAX package's): it no longer raises, and without an input spec it
    refuses as `jit.save` does."""
    from paddle_tpu_torch.static import InputSpec
    for cls in (tquant.ImperativeQuantAware, tquant.PTQ):
        prefix = str(tmp_path / cls.__name__)
        cls().save_quantized_model(torch.nn.Linear(2, 2), prefix,
                                   input_spec=[InputSpec([None, 2])])
        assert os.path.exists(prefix + ".pdmodel")
        with pytest.raises(ValueError, match="input_spec"):
            cls().save_quantized_model(torch.nn.Linear(2, 2), prefix)


def _conv_pair(seed):
    """A JAX net of Conv2Ds (strided, grouped, NHWC) and a Linear, and the
    port's, its weights carried by load_reference_state."""
    paddle.seed(seed)

    class J(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.a = jnn.Conv2D(3, 8, 3, stride=2, padding=1)
            self.b = jnn.Conv2D(8, 8, 3, padding="SAME", groups=4,
                                bias_attr=False)
            self.c = jnn.Conv2D(8, 4, 1, data_format="NHWC")
            self.fc = jnn.Linear(4, 5)

        def forward(self, x):
            x = jnn.functional.relu(self.b(self.a(x)))
            x = self.c(x.transpose([0, 2, 3, 1]))
            return self.fc(x.mean(axis=[1, 2]))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = tnn.Conv2D(3, 8, 3, stride=2, padding=1)
            self.b = tnn.Conv2D(8, 8, 3, padding="SAME", groups=4,
                                bias_attr=False)
            self.c = tnn.Conv2D(8, 4, 1, data_format="NHWC")
            self.fc = tnn.Linear(4, 5)

        def forward(self, x):
            x = tnn.functional.relu(self.b(self.a(x)))
            x = self.c(x.permute(0, 2, 3, 1))
            return self.fc(x.mean((1, 2)))

    ref, port = J(), T()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def test_quantized_conv2d_matches_jax():
    """ImperativeQuantAware wraps every Conv2D and the Linear in both
    packages (state names `a.inner.weight`, ...); outputs and the input's
    straight-through gradient agree."""
    ref, port = _conv_pair(13)
    jquant.ImperativeQuantAware(weight_bits=8, activation_bits=8) \
        .quantize(ref)
    tquant.ImperativeQuantAware(weight_bits=8, activation_bits=8) \
        .quantize(port)
    for name in ("a", "b", "c"):
        assert isinstance(getattr(port, name), tquant.QuantizedConv2D)
        assert isinstance(getattr(port, name).inner, tnn.Conv2D)
    assert isinstance(port.fc, tquant.QuantizedLinear)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    x = np.random.RandomState(14).standard_normal((2, 3, 9, 9)).astype(
        "float32")
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jo, to = ref(jx), port(tx)
    want = np.asarray(jo.numpy())
    np.testing.assert_allclose(to.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    jo.sum().backward()
    to.sum().backward()
    g = np.asarray(jx.grad.numpy())
    np.testing.assert_allclose(tx.grad.numpy(), g, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(g).max()))
    # one wrapper directly, 4-bit, against the JAX one
    jwrap = jquant.QuantizedConv2D(ref.a.inner, weight_bits=4,
                                   activation_bits=4)
    twrap = tquant.QuantizedConv2D(port.a.inner, weight_bits=4,
                                   activation_bits=4)
    want = np.asarray(jwrap(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(twrap(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_auto_cast_covers_weight_only_linear():
    """Under auto_cast(bfloat16) the op runs in bfloat16 in both packages
    (its float32 x, scale and bias cast), the int8 storage untouched;
    outputs within 2e-2 x max |ref| (bf16 rounding in both)."""
    jl, tl = _pair_linear(11, 8, 4)
    jw, tw = jquant.WeightOnlyLinear(jl), tquant.WeightOnlyLinear(tl)
    x = np.random.RandomState(12).standard_normal((2, 8)).astype("float32")
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        want = jw(paddle.to_tensor(x))
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        got = tw(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert str(want._value.dtype) == "bfloat16"
    assert tw.weight_int8.dtype == torch.int8
    ref = np.asarray(want._value.astype("float32"))
    err = np.abs(got.detach().float().numpy() - ref).max()
    assert err <= 2e-2 * max(1.0, np.abs(ref).max())


# -- the quantized GPT -------------------------------------------------------------

def _qpair(bits):
    """A quantized JAX tiny GPT and the port's, its integers and scales
    carried across by load_reference_state."""
    paddle.seed(0)
    ref = jquant.quantize_weights(JGPT(JConfig.tiny(dropout=0.0)).eval(),
                                  bits=bits)
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    tquant.quantize_weights(port, bits=bits)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state(port, state)
    return ref, port, state


@pytest.mark.parametrize("bits", [8, 4])
def test_load_reference_state_carries_integers_and_decode_leaves(bits):
    ref, port, state = _qpair(bits)
    name = f"weight_int{bits}"
    own = port.state_dict()
    keys = [k for k in state if k.endswith(name)]
    assert len(keys) == 6 * 2                  # 6 projections x 2 blocks
    for k in keys:
        assert own[k].dtype == torch.int8
        np.testing.assert_array_equal(own[k].numpy(), state[k].T)
        s = k[:-len(name)] + "weight_scale"
        np.testing.assert_array_equal(own[s].numpy(), state[s])
    W = port.decode_weights()
    q, s = W["blocks"][0][2]
    assert q.dtype == torch.int8 and tuple(q.shape) == (64, 64)
    assert s.shape[-1] == q.shape[0]            # unpacked to full channels
    jq_, js = ref.decode_weights()["blocks"][0][2]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_).T)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_generate_identical_to_jax(bits):
    ref, port, _ = _qpair(bits)
    ids = np.random.RandomState(bits).randint(0, 512, size=(2, 9)) \
        .astype("int64")
    want = ref.generate(paddle.to_tensor(ids), max_new_tokens=12).numpy()
    got = port.generate(ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)
    with GenerationEngine(port, device="cpu", max_slots=2, page_size=4,
                          num_pages=32, prefill_buckets=(16,),
                          max_new_tokens=12, request_timeout_ms=0) as eng:
        outs = [f.result(timeout=120) for f in [
            eng.submit(p, max_new_tokens=12) for p in ids]]
        stats = eng.stats()
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w)
    assert stats["compiles"] == {"prefill[b=16]": 1, "decode[m=2]": 1}
