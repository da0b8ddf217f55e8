"""Quantization (port of `paddle_tpu.quantization`; reference
`fluid/contrib/slim/quantization/`: ImperativeQuantAware, PTQ,
`operators/fake_quantize_op`; and the weight-only direction of
`paddle.nn.quant`).

- Fake quantization for QAT/PTQ: `fake_quantize_dequantize` (per-tensor
  abs-max with a straight-through gradient), the `QuantizedLinear` and
  `QuantizedConv2D` wrappers, and `ImperativeQuantAware.quantize` /
  `PTQ.quantize`, which rewrite Linear and Conv2D sublayers in place.
- Weight-only int8/int4 serving: `WeightOnlyLinear` keeps the integer
  weight and its per-output-channel scale as buffers (no float weight
  stays resident) and dequantizes inside its product;
  `quantize_weights` swaps every Linear for one in place, keeping tied
  Linears tied. Its `quant_decode_leaf` is what
  `GPTForCausalLM.decode_weights` hands the decode math of `generate()`
  and `serving.GenerationEngine`.

- `save_quantized_model` of both writes the quantized model through
  `jit.save`, as the JAX package does; the static-Program passes
  `QuantizationTransformPass` / `QuantizationFreezePass` live in
  `quant_pass`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import functional as F
from ..nn import quant as nn_quant

__all__ = ["fake_quantize_dequantize", "QuantizedLinear", "QuantizedConv2D",
           "ImperativeQuantAware", "PTQ", "WeightOnlyLinear",
           "quantize_weights", "quant_pass", "QuantizationTransformPass",
           "QuantizationFreezePass"]


def fake_quant_array(v, bits):
    """abs-max symmetric fake quantization of a tensor with a
    straight-through gradient (`quant_pass.fake_quant_array`)."""
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.clamp(v.detach().abs().amax(), min=1e-8)
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(v.detach() / scale), -qmax, qmax)
    return v + (q * scale - v).detach()


def fake_quantize_dequantize(x, bits=8, name=None):
    """abs-max symmetric fake quant with STE (reference
    `fake_quantize_dequantize_moving_average_abs_max` op family)."""
    return fake_quant_array(x, bits)


class QuantizedLinear(nn.Module):
    """A Linear whose input and weight pass through fake quantization."""

    def __init__(self, inner: nn.Linear, weight_bits=8, activation_bits=8):
        super().__init__()
        self.inner = inner
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def forward(self, x):
        xq = fake_quantize_dequantize(x, self.activation_bits)
        wq = fake_quantize_dequantize(self.inner.weight, self.weight_bits)
        # F.linear takes the JAX package's [in, out] layout
        return F.linear(xq, wq.t(), self.inner.bias)


class QuantizedConv2D(nn.Module):
    """A Conv2D whose input and weight pass through fake quantization;
    the inner layer's stride, padding, dilation, groups and layout."""

    def __init__(self, inner, weight_bits=8, activation_bits=8):
        super().__init__()
        self.inner = inner
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def forward(self, x):
        xq = fake_quantize_dequantize(x, self.activation_bits)
        wq = fake_quantize_dequantize(self.inner.weight, self.weight_bits)
        return F.conv2d(xq, wq, self.inner.bias, self.inner._stride,
                        self.inner._padding, self.inner._dilation,
                        self.inner._groups, self.inner._data_format)


class ImperativeQuantAware:
    """Reference `imperative/qat.py` ImperativeQuantAware.quantize:
    rewrites Linear (and Conv2D) sublayers in place with fake-quant
    wrappers."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantizable_layer_type=("Conv2D", "Linear"), **kwargs):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.types = set(quantizable_layer_type)

    def quantize(self, model: nn.Module):
        for layer in list(model.modules()):
            for name, sub in list(layer._modules.items()):
                if type(sub).__name__ == "Linear" and "Linear" in self.types:
                    layer._modules[name] = QuantizedLinear(
                        sub, self.weight_bits, self.activation_bits)
                elif type(sub).__name__ == "Conv2D" and \
                        "Conv2D" in self.types:
                    layer._modules[name] = QuantizedConv2D(
                        sub, self.weight_bits, self.activation_bits)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        from .. import jit
        jit.save(model, path, input_spec=input_spec)


class PTQ:
    """Post-training quantization: fake quant with abs-max ranges."""

    def __init__(self, activation_bits=8, weight_bits=8):
        self.activation_bits = activation_bits
        self.weight_bits = weight_bits

    def quantize(self, model):
        return ImperativeQuantAware(
            self.weight_bits, self.activation_bits).quantize(model)

    def save_quantized_model(self, model, path, input_spec=None):
        from .. import jit
        jit.save(model, path, input_spec=input_spec)


class WeightOnlyLinear(nn.Module):
    """Weight-only int8/int4 linear.

    Holds the quantized weight as an int8 buffer (`weight_int8` [out, in],
    or `weight_int4` packed [ceil(out / 2), in]) and `weight_scale`
    float32 [out], both buffers, plus the inner Linear's bias; the float
    weight is not kept. `forward` dequantizes into a temporary inside
    `nn.quant.weight_only_linear`."""

    def __init__(self, inner: nn.Linear, bits: int = 8):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"WeightOnlyLinear supports bits=8 or 4, "
                             f"got {bits}")
        self.weight_bits = bits
        q, scale = nn_quant.weight_quantize(inner.weight,
                                            f"weight_only_int{bits}")
        self.register_buffer(self._qname, q)
        self.register_buffer("weight_scale", scale)
        self.bias = inner.bias
        self._out_features = inner.out_features

    @property
    def _qname(self) -> str:
        return "weight_int8" if self.weight_bits == 8 else "weight_int4"

    @property
    def quant_weight(self) -> torch.Tensor:
        return getattr(self, self._qname)

    def quant_weight_spec(self):
        """(quant buffer attr, scale attr, bits) of this layer."""
        return [(self._qname, "weight_scale", self.weight_bits)]

    def quant_decode_leaf(self):
        """(q_int8 [out, in], scale [out]) for the decode-weight dict
        (`models/gpt.py`): int4 unpacks ONCE to int8 values here (still
        4x smaller than float32 on the device), so the decode math has one
        integer dequant form."""
        q, s = self.quant_weight, self.weight_scale
        if self.weight_bits == 4:
            q = nn_quant.unpack_int4(q, s.shape[-1])
        return (q, s)

    def forward(self, x):
        return nn_quant.weight_only_linear(
            x, self.quant_weight, self.weight_scale, self.bias,
            weight_dtype="int8" if self.weight_bits == 8 else "int4")


def quantize_weights(model: nn.Module, bits: int = 8,
                     _seen=None) -> nn.Module:
    """Swap every Linear for a WeightOnlyLinear in place (weight-only
    PTQ; bits=8 stores int8, bits=4 packed two nibbles a byte). A Linear
    shared by several parents (tied heads) is quantized once and the one
    replacement is linked everywhere, keeping the tying; fake-quant
    wrappers (QuantizedLinear) keep their inner Linear."""
    if bits not in (8, 4):
        raise NotImplementedError("weight-only quantization supports "
                                  "bits=8 or bits=4")
    seen = _seen if _seen is not None else {}
    for name, sub in list(model._modules.items()):
        if isinstance(sub, nn.Linear):
            rep = seen.get(id(sub))
            if rep is None:
                rep = seen[id(sub)] = WeightOnlyLinear(sub, bits=bits)
            model._modules[name] = rep
        elif isinstance(sub, QuantizedLinear):
            continue   # fake-quant wrappers own their inner Linear
        elif sub is not None:
            quantize_weights(sub, bits, seen)
    return model


from . import quant_pass  # noqa: E402,F401
from .quant_pass import (QuantizationFreezePass,  # noqa: E402,F401
                         QuantizationTransformPass)
